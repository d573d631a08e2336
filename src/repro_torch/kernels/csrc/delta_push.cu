// Count-delta aggregation for the parameter-server push (sm_90a): two
// kernels that scatter with int32 atomics.
//
// delta_push replaces the Pallas TPU kernel
// repro/kernels/delta_push.py::_delta_kernel (pallas_call in
// delta_push_call): the dense reassignment delta of T tokens.  For every
// token t with changed[t] != 0 it adds -1 at z_old[t] and +1 at z_new[t]
//   * in out [R, K],      at row rows[t];
//   * in ndk_out [D, K],  at row docs[t]   (when given);
//   * in nk_out [K]                        (when given).
// Rows outside [0, R) and [0, D), and topics outside [0, K), are dropped
// in that destination alone.  With all three it is a training group's whole
// merge -- n_wk, n_dk and n_k -- in one launch; with `out` alone it is the
// TPU kernel's function, the dense half of a routed push.
//
// delta_apply_coo replaces repro/kernels/delta_push.py::_coo_kernel
// (pallas_call in delta_apply_coo_call): the server-side apply of a
// (row, col, val) COO buffer,
//   out[rows[j], cols[j]] += vals[j]
// for every entry with vals[j] != 0, 0 <= rows[j] < R and 0 <= cols[j] < K.
// Value-0 entries are padding.
//
// Design.  The TPU has no scatter, so its kernels build one-hot matrices
// and multiply them on the MXU, tile by tile over [V, K], into fresh
// zero-filled outputs.  Hopper has int32 atomics in the L2: each thread
// adds its +-1 (or its value) where it belongs, straight into the tables
// the caller passes (row-major int32, no K padding), so no delta buffer is
// zero-filled and nothing is added afterwards.  Integer adds commute and
// are exact: the result equals the plain version (index_put_ with
// accumulate) bitwise whatever the order of the atomics.
//
// What bounds them.  Bytes: the `changed` mask (or `vals`) once per
// entry; of the index streams (rows, docs, z_old, z_new; rows, cols) only
// the 32-byte sectors that hold an entry that adds; and each touched
// 32-byte sector of a destination read and written once in the L2.  At a
// snapshot group (8,192 tokens) that is well
// under a microsecond, below any launch: the launch and one dependent
// memory round trip set the time.  The design does what it can there:
//   * every load of a token (changed, rows, docs, z_old, z_new) issues at
//     once, with no branch on `changed` before them; 16-byte loads of 4
//     tokens a thread where the batch is 16-byte aligned, a scalar tail;
//   * the grid is sized from T and the SM count (a 32-thread block per
//     SM's share of the quads, up to 512), so 8,192 tokens spread over 64
//     SMs, not 32; past that, at most 2 blocks per SM stride over the rest;
//   * n_k, the most contended target (2 atomics a token on K addresses),
//     is a per-block histogram in shared memory, flushed with one global
//     atomic per non-zero entry.  It takes K int32 rounded up to 4: it fits
//     while 4 * ceil(K / 4) * 4 bytes <= the block's opt-in shared memory
//     (232,448 bytes on an H100: K <= 58,112).  Past that the launch
//     returns cudaErrorInvalidValue and the wrapper raises, as alias_build
//     does past its row limit (training never gets there: its alias
//     tables, built first, stop at K of about 28,000);
//   * n_wk and n_dk get global atomics.  Merging a warp's equal addresses
//     first (__match_any_sync) was slower at both executors' groups: on
//     trained data only 0.1 % (n_wk) and 3 % (n_dk) of a warp's keys repeat.
// At a pipelined group (1.8 M tokens into 82 MB of tables) the time goes
// to the scattered global atomics, about 40 G/s in the L2, not to the
// token streams; at a snapshot group the n_k histogram's zero-fill,
// barriers and flush cost about as much as the launch's own work.
// The launcher sets the device only when it is not the current one, and
// keeps the SM count per device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxThreads = 512;
constexpr int kBlocksPerSM = 2;

struct PushArgs {
  const int* rows;
  const int* z_old;
  const int* z_new;
  const unsigned char* changed;
  const int* docs;
  int* out;
  int* ndk;
  int* nk;
  int T, R, D, K, quads;
};

struct CooArgs {
  const int* rows;
  const int* cols;
  const int* vals;
  int* out;
  int M, R, K, quads;
};

// out[r, c] += v for an entry inside [0, R) x [0, K) with v != 0: the one
// scatter both kernels make.
__device__ __forceinline__ void scatter_add(int* out, int r, int c, int v,
                                            int R, int K) {
  if (v != 0 && (unsigned)r < (unsigned)R && (unsigned)c < (unsigned)K)
    atomicAdd(out + (int64_t)r * K + c, v);
}

template <bool DOCS, bool NK>
__device__ __forceinline__ void push_token(const PushArgs& a, int* s_nk,
                                           int r, int d, int zo, int zn,
                                           bool on) {
  const int m = on ? 1 : 0;
  scatter_add(a.out, r, zo, -m, a.R, a.K);
  scatter_add(a.out, r, zn, m, a.R, a.K);
  if (DOCS) {
    scatter_add(a.ndk, d, zo, -m, a.D, a.K);
    scatter_add(a.ndk, d, zn, m, a.D, a.K);
  }
  if (NK && on) {
    if ((unsigned)zo < (unsigned)a.K) atomicAdd(s_nk + zo, -1);
    if ((unsigned)zn < (unsigned)a.K) atomicAdd(s_nk + zn, 1);
  }
}

template <bool DOCS, bool NK>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
    delta_push_kernel(PushArgs a) {
  extern __shared__ int4 s_nk4[];
  int* s_nk = reinterpret_cast<int*>(s_nk4);
  const int k4 = (a.K + 3) / 4;
  if (NK) {
    for (int i = threadIdx.x; i < k4; i += blockDim.x)
      s_nk4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;

  // 4 tokens a thread, five 16-byte (changed: 4-byte) loads issued at once
  for (int q = i0; q < a.quads; q += stride) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(a.rows) + q);
    const int4 zo = __ldg(reinterpret_cast<const int4*>(a.z_old) + q);
    const int4 zn = __ldg(reinterpret_cast<const int4*>(a.z_new) + q);
    const uchar4 ch = __ldg(reinterpret_cast<const uchar4*>(a.changed) + q);
    int4 d = make_int4(0, 0, 0, 0);
    if (DOCS) d = __ldg(reinterpret_cast<const int4*>(a.docs) + q);
    push_token<DOCS, NK>(a, s_nk, r.x, d.x, zo.x, zn.x, ch.x);
    push_token<DOCS, NK>(a, s_nk, r.y, d.y, zo.y, zn.y, ch.y);
    push_token<DOCS, NK>(a, s_nk, r.z, d.z, zo.z, zn.z, ch.z);
    push_token<DOCS, NK>(a, s_nk, r.w, d.w, zo.w, zn.w, ch.w);
  }
  // the tokens past the last whole quad (every token of an unaligned batch)
  for (int t = 4 * a.quads + i0; t < a.T; t += stride) {
    const int r = __ldg(a.rows + t);
    const int zo = __ldg(a.z_old + t);
    const int zn = __ldg(a.z_new + t);
    const unsigned char ch = __ldg(a.changed + t);
    const int d = DOCS ? __ldg(a.docs + t) : 0;
    push_token<DOCS, NK>(a, s_nk, r, d, zo, zn, ch);
  }

  if (NK) {
    __syncthreads();
    for (int i = threadIdx.x; i < k4; i += blockDim.x) {
      const int4 h = s_nk4[i];   // entries past K stay 0
      if (h.x) atomicAdd(a.nk + 4 * i, h.x);
      if (h.y) atomicAdd(a.nk + 4 * i + 1, h.y);
      if (h.z) atomicAdd(a.nk + 4 * i + 2, h.z);
      if (h.w) atomicAdd(a.nk + 4 * i + 3, h.w);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
    delta_apply_coo_kernel(CooArgs a) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int q = i0; q < a.quads; q += stride) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(a.rows) + q);
    const int4 c = __ldg(reinterpret_cast<const int4*>(a.cols) + q);
    const int4 v = __ldg(reinterpret_cast<const int4*>(a.vals) + q);
    scatter_add(a.out, r.x, c.x, v.x, a.R, a.K);
    scatter_add(a.out, r.y, c.y, v.y, a.R, a.K);
    scatter_add(a.out, r.z, c.z, v.z, a.R, a.K);
    scatter_add(a.out, r.w, c.w, v.w, a.R, a.K);
  }
  for (int j = 4 * a.quads + i0; j < a.M; j += stride) {
    const int r = __ldg(a.rows + j);
    const int c = __ldg(a.cols + j);
    const int v = __ldg(a.vals + j);
    scatter_add(a.out, r, c, v, a.R, a.K);
  }
}

using PushKernel = void (*)(PushArgs);

// indexed by docs * 2 + nk
const PushKernel kPushKernels[4] = {
    delta_push_kernel<false, false>, delta_push_kernel<false, true>,
    delta_push_kernel<true, false>, delta_push_kernel<true, true>,
};

struct DeviceInfo {
  int sms;
  int smem_optin;
  int smem_set[4];   // the dynamic shared memory each kernel may take
};
DeviceInfo g_info[kMaxDevices];

// Make `device` current if it is not, and fill its entry once.
cudaError_t prepare(int device, DeviceInfo** info) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  DeviceInfo* d = &g_info[device];
  if (d->sms == 0) {
    err = cudaDeviceGetAttribute(&d->smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) {
      d->sms = 0;
      return err;
    }
  }
  *info = d;
  return cudaSuccess;
}

// Blocks of 32..512 threads, one SM's share of `units` each (so a small
// batch spreads over as many SMs as it can), at most kBlocksPerSM per SM.
void grid_for(int units, int sms, int* blocks, int* threads) {
  const int per_sm = (units + sms - 1) / sms;
  int t = 32;
  while (t < per_sm && t < kMaxThreads) t *= 2;
  const int b = (units + t - 1) / t;
  const int cap = sms * kBlocksPerSM;
  *threads = t;
  *blocks = b < 1 ? 1 : (b < cap ? b : cap);
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p % bytes) == 0;
}

}  // namespace

extern "C" int delta_push_launch(const void* rows, const void* z_old,
                                 const void* z_new, const void* changed,
                                 const void* docs, void* out, void* ndk_out,
                                 void* nk_out, int T, int R, int D, int K,
                                 int device, void* stream) {
  DeviceInfo* info;
  cudaError_t err = prepare(device, &info);
  if (err != cudaSuccess) return (int)err;
  PushArgs a = {(const int*)rows, (const int*)z_old, (const int*)z_new,
                (const unsigned char*)changed, (const int*)docs, (int*)out,
                (int*)ndk_out, (int*)nk_out, T, R, D, K, 0};
  const bool vec = aligned(rows, 16) && aligned(z_old, 16) &&
                   aligned(z_new, 16) && aligned(changed, 4) &&
                   (docs == nullptr || aligned(docs, 16));
  a.quads = vec ? T / 4 : 0;
  const int smem = nk_out == nullptr ? 0 : (K + 3) / 4 * 16;
  if (smem > info->smem_optin)
    return (int)cudaErrorInvalidValue;  // the n_k histogram does not fit
  const int which = (docs != nullptr) * 2 + (nk_out != nullptr);
  if (smem > 48 * 1024 && smem > info->smem_set[which]) {
    err = cudaFuncSetAttribute(kPushKernels[which],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    info->smem_set[which] = smem;
  }
  int blocks, threads;
  grid_for(a.quads + (T - 4 * a.quads), info->sms, &blocks, &threads);
  kPushKernels[which]<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int delta_apply_coo_launch(const void* rows, const void* cols,
                                      const void* vals, void* out, int M,
                                      int R, int K, int device,
                                      void* stream) {
  DeviceInfo* info;
  cudaError_t err = prepare(device, &info);
  if (err != cudaSuccess) return (int)err;
  CooArgs a = {(const int*)rows, (const int*)cols, (const int*)vals,
               (int*)out, M, R, K, 0};
  const bool vec =
      aligned(rows, 16) && aligned(cols, 16) && aligned(vals, 16);
  a.quads = vec ? M / 4 : 0;
  int blocks, threads;
  grid_for(a.quads + (M - 4 * a.quads), info->sms, &blocks, &threads);
  delta_apply_coo_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* delta_push_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
