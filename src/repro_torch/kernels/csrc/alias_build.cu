// Vose alias-table construction, one thread per row (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/alias_build.py::_alias_kernel
// (pallas_call in alias_build_call) and the argsort preprocessing of
// repro/kernels/ops.py::alias_build.  Same function: weights scaled to mean
// 1, the two-stack retirement loop, prob clipped to [0, 1].  The induced pmf
// equals that of the plain version, repro_torch/core/alias.py::
// build_alias_rows; the alias assignments may differ (they depend on the
// order the stacks are filled, and entries with q == 1 go in neither stack
// here: they stay self-aliased prob-1 buckets).
//
// Design.  The TPU kernel pops and pushes its stacks with one-hot selects
// over K lanes, O(K) per step and O(K^2) per row, after an argsort.  Here a
// thread owns one row and indexes its stacks directly: one pass sums the
// row (in double), one pass scales it and fills the stacks, then the loop
// retires one small entry per step, O(K) per row in all.  Both stacks share
// one K-slot array of the wrapper's [V, K] int32 scratch -- smalls grow up
// from slot 0, larges down from slot K-1; an index is in at most one stack,
// so they never meet -- and the residual weights live in the prob output.
// Global scratch rather than shared memory keeps every row in flight at
// once: the loop is a chain of dependent loads, and occupancy hides them.
//
// Bound.  At least 12 bytes per [V, K] entry move: the weight read once,
// prob and alias written once.  The kernel is bound by memory bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void alias_build_kernel(const float* __restrict__ weights,
                                   float* __restrict__ prob,
                                   int* __restrict__ alias,
                                   int* __restrict__ stack, int V, int K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= V) return;
  const int64_t base = (int64_t)row * K;
  const float* wr = weights + base;
  float* q = prob + base;          // residual weights, then probabilities
  int* al = alias + base;
  int* stk = stack + base;

  double sum = 0.0;
  for (int k = 0; k < K; ++k) sum += (double)wr[k];
  float psum = (float)sum;
  psum = psum < 1e-30f ? 1e-30f : psum;
  const float scale = (float)K / psum;

  // ascending fill: the top of each stack is its largest index, the order
  // in which the TPU kernel pops its argsorted stacks
  int ns = 0, nl = 0;
  for (int k = 0; k < K; ++k) {
    const float qk = wr[k] * scale;
    q[k] = qk;
    al[k] = k;
    if (qk < 1.0f) {
      stk[ns++] = k;
    } else if (qk > 1.0f) {
      stk[K - 1 - nl] = k;
      ++nl;
    }
  }

  while (ns > 0 && nl > 0) {
    const int s = stk[ns - 1];
    const int l = stk[K - nl];
    const float q_l = (q[l] + q[s]) - 1.0f;   // q[s] stays as prob[s]
    al[s] = l;
    q[l] = q_l;
    --ns;
    if (q_l < 1.0f) {                          // donor exhausted below 1
      --nl;
      stk[ns++] = l;
    }
  }
  // entries never retired keep probability 1 (self-aliased)
  for (int i = 0; i < ns; ++i) q[stk[i]] = 1.0f;
  for (int i = K - nl; i < K; ++i) q[stk[i]] = 1.0f;
  for (int k = 0; k < K; ++k) q[k] = fminf(fmaxf(q[k], 0.0f), 1.0f);
}

}  // namespace

extern "C" int alias_build_launch(const void* weights, void* prob,
                                  void* alias, void* stack, int V, int K,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const int blocks = (V + threads - 1) / threads;
  alias_build_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)weights, (float*)prob, (int*)alias, (int*)stack, V, K);
  return (int)cudaGetLastError();
}

extern "C" const char* alias_build_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
