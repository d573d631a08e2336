// Count-delta aggregation for the parameter-server push (sm_90a): two
// kernels, one thread per token or COO entry, int32 atomics.
//
// delta_push replaces the Pallas TPU kernel
// repro/kernels/delta_push.py::_delta_kernel (pallas_call in
// delta_push_call): the dense reassignment delta
//   out[rows[i], z_old[i]] -= 1,  out[rows[i], z_new[i]] += 1
// for every token i with changed[i] != 0 and 0 <= rows[i] < R.
//
// delta_apply_coo replaces repro/kernels/delta_push.py::_coo_kernel
// (pallas_call in delta_apply_coo_call): the server-side apply of a
// (row, col, val) COO buffer,
//   out[rows[j], cols[j]] += vals[j]
// for every entry with vals[j] != 0, 0 <= rows[j] < R and 0 <= cols[j] < K.
// Value-0 entries are padding.
//
// Design.  The TPU has no scatter, so its kernels build one-hot matrices
// and multiply them on the MXU, tile by tile over [V, K].  Hopper has
// int32 atomics in the L2: each thread adds its +-1 (or its value) where
// it belongs, in a row-major [R, K] int32 buffer with no K padding.
// Integer adds commute and are exact, so the result equals the plain
// version (an index_put_ with accumulate) bitwise whatever the order.
// Neither kernel writes a fresh buffer: both accumulate into the one the
// caller passes -- zeroed by the wrapper for a delta, or the count table
// itself where nothing else reads it.  Entries outside the ranges above
// are dropped, as the TPU kernels' one-hots match nothing there.
//
// Bound.  Per token 13 bytes of input (three int32 and a bool), per COO
// entry 12; each distinct 32-byte sector of the output that an atomic
// touches is read and written once in the L2.  A few integer operations
// per token: both kernels are bound by memory.  Zipf-skewed rows make many
// atomics land on one row; warp aggregation is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void delta_push_kernel(const int* __restrict__ rows,
                                  const int* __restrict__ z_old,
                                  const int* __restrict__ z_new,
                                  const unsigned char* __restrict__ changed,
                                  int* __restrict__ out, int T, int R,
                                  int K) {
  const int stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T; t += stride) {
    if (!changed[t]) continue;
    const int r = rows[t];
    if (r < 0 || r >= R) continue;
    int* row = out + (int64_t)r * K;
    const int zo = z_old[t];
    const int zn = z_new[t];
    if (zo >= 0 && zo < K) atomicAdd(row + zo, -1);
    if (zn >= 0 && zn < K) atomicAdd(row + zn, 1);
  }
}

__global__ void delta_apply_coo_kernel(const int* __restrict__ rows,
                                       const int* __restrict__ cols,
                                       const int* __restrict__ vals,
                                       int* __restrict__ out, int M, int R,
                                       int K) {
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < M; j += stride) {
    const int v = vals[j];
    if (v == 0) continue;
    const int r = rows[j];
    const int c = cols[j];
    if (r < 0 || r >= R || c < 0 || c >= K) continue;
    atomicAdd(out + (int64_t)r * K + c, v);
  }
}

int grid_for(int n, int threads) {
  // enough blocks to fill the card several times over; the loops stride
  const int blocks = (n + threads - 1) / threads;
  return blocks < 132 * 32 ? blocks : 132 * 32;
}

}  // namespace

extern "C" int delta_push_launch(const void* rows, const void* z_old,
                                 const void* z_new, const void* changed,
                                 void* out, int T, int R, int K, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  delta_push_kernel<<<grid_for(T, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)z_old, (const int*)z_new,
      (const unsigned char*)changed, (int*)out, T, R, K);
  return (int)cudaGetLastError();
}

extern "C" int delta_apply_coo_launch(const void* rows, const void* cols,
                                      const void* vals, void* out, int M,
                                      int R, int K, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  delta_apply_coo_kernel<<<grid_for(M, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)cols, (const int*)vals, (int*)out, M, R,
      K);
  return (int)cudaGetLastError();
}

extern "C" const char* delta_push_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
