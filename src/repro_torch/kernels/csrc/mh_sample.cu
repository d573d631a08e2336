// LightLDA Metropolis-Hastings chain, one thread per token (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mh_sample.py::_mh_kernel
// (pallas_call in mh_sample_call).  Same function as the plain version,
// repro_torch/core/lightlda.py::mh_chain: per token, mh_steps x (alias word
// proposal with the single-uniform trick + MH accept, pre-drawn doc proposal
// + MH accept); frozen=1 drops the -dw correction on n_wk/n_k (fold-in).
//
// Design.  The TPU kernel takes pre-gathered [B, Kp] rows and selects
// columns with one-hot lane reductions.  Here each thread reads the few
// table entries it needs in place: nwk/aprob/aalias rows by the token's
// word index w, ndk rows by its document index d, and nk (K floats) from
// shared memory.  No [T, K] pre-gather and no K padding.
//
// Bound.  Gathers: about ten scattered 4-byte reads per token per MH step,
// each in a 32-byte sector, plus the per-token streams; the arithmetic is a
// few dozen flops per step.  Tokens of one word or document share sectors,
// so the least traffic is the distinct sectors the chain reads: the kernel
// is bound by memory sectors.
//
// Parity.  The result must equal the plain version bitwise, so:
//   * build with --fmad=false: u*K then (u*K - bucket) must not fuse;
//   * no fast math: fp32 '/' is IEEE div_rn;
//   * the operation order of the plain version is kept:
//     ((ndk - e + alpha) * (nwk - e_wk + beta)) / (nk - e_wk + vbeta), and
//     (p(z') q(z)) / (max(p(z),1e-30) max(q(z'),1e-30));
//   * vbeta = V*beta arrives rounded once, from double, as JAX rounds it;
//   * max() keeps a NaN operand as jnp.maximum / torch.clamp_min do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float max_floor(float x) {
  // jnp.maximum(x, 1e-30) / torch.clamp_min: a NaN stays NaN
  return (x < 1e-30f) ? 1e-30f : x;
}

__global__ void mh_sample_kernel(
    const int* __restrict__ z0, const int* __restrict__ w,
    const int* __restrict__ d, const float* __restrict__ nwk,
    const int* __restrict__ ndk, const float* __restrict__ nk,
    const float* __restrict__ aprob, const int* __restrict__ aalias,
    const float* __restrict__ u_word, const float* __restrict__ u_waccept,
    const int* __restrict__ z_doc, const float* __restrict__ u_daccept,
    int* __restrict__ z_out, int T, int K, int steps, float alpha,
    float beta, float vbeta, int frozen) {
  extern __shared__ float nk_s[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) nk_s[k] = nk[k];
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;

  const int zt0 = z0[t];
  const int64_t wrow = (int64_t)w[t] * K;
  const int64_t drow = (int64_t)d[t] * K;
  const float* nwk_w = nwk + wrow;
  const int* ndk_d = ndk + drow;

  // collapsed posterior factors with the -dw correction w.r.t. z0
  auto p = [&](int k) -> float {
    const float e = (k == zt0) ? 1.0f : 0.0f;
    const float e_wk = frozen ? 0.0f : e;
    const float a = ((float)ndk_d[k] - e) + alpha;
    const float b = (nwk_w[k] - e_wk) + beta;
    const float c = (nk_s[k] - e_wk) + vbeta;
    return (a * b) / c;
  };
  auto q_word = [&](int k) -> float {
    return (nwk_w[k] + beta) / (nk_s[k] + vbeta);
  };
  auto q_doc = [&](int k) -> float { return (float)ndk_d[k] + alpha; };

  const float kf = (float)K;
  int z = zt0;
  for (int s = 0; s < steps; ++s) {
    const int64_t at = (int64_t)s * T + t;
    // word proposal via the alias row (single-uniform trick)
    const float scaled = u_word[at] * kf;
    int bucket = (int)scaled;
    bucket = bucket < K - 1 ? bucket : K - 1;
    const float coin = scaled - (float)bucket;
    const int zp_w = (coin < aprob[wrow + bucket]) ? bucket
                                                   : aalias[wrow + bucket];
    float ratio = (p(zp_w) * q_word(z)) /
                  (max_floor(p(z)) * max_floor(q_word(zp_w)));
    if (u_waccept[at] < ratio) z = zp_w;

    // doc proposal (pre-drawn; independent of the chain state)
    const int zp_d = z_doc[at];
    ratio = (p(zp_d) * q_doc(z)) / (max_floor(p(z)) * max_floor(q_doc(zp_d)));
    if (u_daccept[at] < ratio) z = zp_d;
  }
  z_out[t] = z;
}

}  // namespace

extern "C" int mh_sample_launch(
    const void* z0, const void* w, const void* d, const void* nwk,
    const void* ndk, const void* nk, const void* aprob, const void* aalias,
    const void* u_word, const void* u_waccept, const void* z_doc,
    const void* u_daccept, void* z_out, int T, int K, int steps, float alpha,
    float beta, float vbeta, int frozen, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mh_sample_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  const int blocks = (T + threads - 1) / threads;
  mh_sample_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)z0, (const int*)w, (const int*)d, (const float*)nwk,
      (const int*)ndk, (const float*)nk, (const float*)aprob,
      (const int*)aalias, (const float*)u_word, (const float*)u_waccept,
      (const int*)z_doc, (const float*)u_daccept, (int*)z_out, T, K, steps,
      alpha, beta, vbeta, frozen);
  return (int)cudaGetLastError();
}

extern "C" const char* mh_sample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
