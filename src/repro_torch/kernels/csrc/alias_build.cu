// Vose alias-table construction, a warp per row in shared memory (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/alias_build.py::_alias_kernel
// (pallas_call in alias_build_call) and the argsort preprocessing of
// repro/kernels/ops.py::alias_build.  Same function as the plain version,
// repro_torch/core/alias.py::build_alias_rows, and bitwise equal to it in
// prob and alias: weights scaled to mean 1 by the row sum in XLA's order,
// the two-stack retirement loop in the plain version's stack order, prob
// clipped to [0, 1].
//
// The order.  The plain small and large stacks hold their members in
// ascending index order and pop from the top, and a large whose residual
// falls below 1 is pushed on the small stack and popped at the very next
// step.  So the larges are taken from the top index down, and so are the
// smalls, each demoted large retired next into the large after it; each
// step is alias[s] = l and q_l = (q_l + q_s) - 1 exactly.
//
// Design.  One warp owns one row.  It loads the row coalesced into shared
// memory and sums it in XLA's CPU order (core/alias.py::row_sum): the
// columns padded with zeros to a multiple of 32 (half of the padding
// before them), lane j adding window j from left to right, then the window
// sums again in windows while more than 32 remain, the last <= 32 from left
// to right.  Lane j reads its window one step behind lane j - 1, so the 32
// lanes read 32 different banks.  The warp scales the row to q in place and
// classifies it with __ballot_sync into two K-bit masks: small (q < 1) and
// large (the rest, NaN and q == 1 included, as the plain version's
// ~is_small), and writes the smalls' q, in the order they retire, into a
// sequence.  Lane 0 replays the chain.  Between two demotions every small
// retires into the same large, so it takes the sequence four at a time:
// one 16-byte read (issued a quad ahead), the four steps' adds, and, if no
// residual fell below 1, one 16-byte write of the quad's alias over its q;
// only a quad with a demotion goes step by step, finding the next large in
// the large mask with __clz.  The chain ends with the number of smalls it
// retired and the current large: the larges above it were demoted and
// retired into the large after each, their residuals written into q.  The
// warp's coalesced write-out rebuilds every entry from the masks: a small's
// place in the sequence (a popcount) gives its alias, a retired large's
// alias is the next large below it, and entries never retired keep prob 1
// and alias themselves.  No [V, K] scratch: a row takes
// (2 K4 + round4(2 ceil(K/32))) * 4 bytes of shared memory, K4 = K rounded
// up to 4 (8,256 at K = 1,000), and the launch picks the warps per block
// that keep the most rows in flight per SM.
//
// Bound.  At least 12 bytes per [V, K] entry move: the weight read once,
// prob and alias written once.  The kernel is bound by memory bytes; the
// chain (about K dependent adds a row, on one lane) is what it has to
// hide, across the rows in flight.
//
// Parity.  --fmad=false; fp32 '/' is IEEE div_rn; scale = (float)K / psum
// and q = w * scale, as the plain version's tensor division and product.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int mask_words(int K) {
  return (K + kWarp - 1) / kWarp;
}
// Shared-memory words of one row: q [K4], the small sequence [K4], the
// small and large masks.  A multiple of 4, so every row is 16-byte aligned.
__host__ __device__ inline int row_words(int K) {
  return 2 * round4(K) + round4(2 * mask_words(K));
}

// Sum of src[0, n) in XLA's CPU order; every lane returns it.  Window sums
// go to scratch (at most n/32 + n/1024 + ... words).
__device__ float xla_row_sum(const float* src, int n, float* scratch,
                             int lane) {
  while (n > kWarp) {
    const int nw = (n + kWarp - 1) / kWarp;
    const int off = (nw * kWarp - n) / 2;
    for (int j0 = 0; j0 < nw; j0 += kWarp) {
      const int j = j0 + lane;                 // this lane's window
      const int base = j * kWarp - off;        // its first column
      float acc = 0.0f;                        // 0 + x == x: the padding
      for (int t = 0; t < 2 * kWarp - 1; ++t) {
        const int i = t - lane;                // lane j lags lane 0 by j
        const int p = base + i;
        if (j < nw && i >= 0 && i < kWarp && p >= 0 && p < n)
          acc = acc + src[p];
      }
      if (j < nw) scratch[j] = acc;
    }
    __syncwarp();
    src = scratch;
    scratch += nw;
    n = nw;
  }
  float acc = src[0];                          // one address: a broadcast
  for (int i = 1; i < n; ++i) acc = acc + src[i];
  return acc;
}

// The next set bit below the cursor (word wi, its remaining bits), from
// the top down, or -1.
__device__ __forceinline__ int next_index(const unsigned* mask, int& wi,
                                          unsigned& bits) {
  while (bits == 0) {
    if (--wi < 0) return -1;
    bits = mask[wi];
  }
  const int b = 31 - __clz(bits);
  bits ^= 1u << b;
  return wi * kWarp + b;
}

__device__ __forceinline__ float4 splat(int l) {
  const float f = __int_as_float(l);
  return make_float4(f, f, f, f);
}

struct ChainEnd {
  int retired;  // smalls of the sequence retired (a prefix of it)
  int large;    // the current large at the end; K if the chain never ran
};

// The retirement chain on one lane (see the header).  seq [n_small] holds
// the smalls' q in retirement order; each retired entry's alias (as float
// bits) replaces its q.
__device__ ChainEnd retire(float* q, float* seq, const unsigned* lmask,
                           int nw, int n_small, int K) {
  ChainEnd end{0, K};
  int li = nw - 1;
  unsigned lb = lmask[li];
  int l = next_index(lmask, li, lb);
  if (l < 0 || n_small == 0) return end;
  float ql = q[l];
  float4 lq = splat(l);
  float4* seq4 = reinterpret_cast<float4*>(seq);
  const int last4 = round4(K) / 4 - 1;
  float4 cur = seq4[0];
  for (int i = 0;; i += 4) {
    const int ahead = i / 4 + 1;
    const float4 nxt = seq4[ahead < last4 ? ahead : last4];
    if (i + 4 <= n_small) {
      const float a0 = (ql + cur.x) - 1.0f;
      const float a1 = (a0 + cur.y) - 1.0f;
      const float a2 = (a1 + cur.z) - 1.0f;
      const float a3 = (a2 + cur.w) - 1.0f;
      if (!(a0 < 1.0f || a1 < 1.0f || a2 < 1.0f || a3 < 1.0f)) {
        seq4[i / 4] = lq;                       // no demotion in the quad
        ql = a3;
        if (i + 4 == n_small) break;
        cur = nxt;
        continue;
      }
    }
    // a demotion (or the sequence's end) in this quad: step by step
    const float qs[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j >= n_small) break;
      seq[i + j] = __int_as_float(l);
      ql = (ql + qs[j]) - 1.0f;
      while (ql < 1.0f) {                       // l demoted: retired next
        q[l] = ql;
        const int nl = next_index(lmask, li, lb);
        if (nl < 0) {                           // no large left: l stays
          end.retired = i + j + 1;
          end.large = l;
          return end;
        }
        ql = (q[nl] + ql) - 1.0f;
        l = nl;
      }
    }
    lq = splat(l);
    if (i + 4 >= n_small) break;
    cur = nxt;
  }
  end.retired = n_small;
  end.large = l;
  return end;
}

__global__ void alias_build_kernel(const float* __restrict__ weights,
                                   float* __restrict__ prob,
                                   int* __restrict__ alias, int V, int K) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= V) return;
  const int nw = mask_words(K);
  float* q = reinterpret_cast<float*>(smem4) + (size_t)warp * row_words(K);
  float* seq = q + round4(K);
  unsigned* smask = reinterpret_cast<unsigned*>(seq + round4(K));
  unsigned* lmask = smask + nw;
  const int64_t base = (int64_t)row * K;

  for (int c = lane; c < K; c += kWarp) q[c] = weights[base + c];
  __syncwarp();
  float psum = xla_row_sum(q, K, seq, lane);
  psum = psum < 1e-30f ? 1e-30f : psum;        // clamp_min: NaN stays NaN
  const float scale = (float)K / psum;
  __syncwarp();                                // seq's window sums are read

  // classify from the top word down; the smalls' q go to seq in order
  const unsigned above_lane = 0xfffffffeu << lane;
  int n_small = 0;
  for (int i = nw - 1; i >= 0; --i) {
    const int c = i * kWarp + lane;
    bool small = false;
    float qc = 0.0f;
    if (c < K) {
      qc = q[c] * scale;
      q[c] = qc;
      small = qc < 1.0f;
    }
    const unsigned sb = __ballot_sync(kAll, small);
    const unsigned lb = __ballot_sync(kAll, c < K && !small);
    if (small) seq[n_small + __popc(sb & above_lane)] = qc;
    n_small += __popc(sb);
    if (lane == 0) {
      smask[i] = sb;
      lmask[i] = lb;
    }
  }
  __syncwarp();
  ChainEnd end{0, K};
  if (lane == 0) end = retire(q, seq, lmask, nw, n_small, K);
  __syncwarp();                                // lane 0's writes are seen
  end.retired = __shfl_sync(kAll, end.retired, 0);
  end.large = __shfl_sync(kAll, end.large, 0);

  // write out from the top word down, counting the smalls above
  int above = 0;
  for (int i = nw - 1; i >= 0; --i) {
    const int c = i * kWarp + lane;
    const unsigned sb = smask[i];
    if (c < K) {
      float p = 1.0f;
      int a = c;
      if (sb >> lane & 1u) {
        const int pos = above + __popc(sb & above_lane);
        if (pos < end.retired) {
          p = q[c];
          a = __float_as_int(seq[pos]);
        }
      } else if (c > end.large) {              // a large, demoted and retired
        p = q[c];
        int wi = i;
        unsigned bits = lmask[i] & ((1u << lane) - 1u);
        a = next_index(lmask, wi, bits);       // the next large below
      }
      prob[base + c] = p < 0.0f ? 0.0f : (p > 1.0f ? 1.0f : p);  // clamp
      alias[base + c] = a;
    }
    above += __popc(sb);
  }
}

struct Config {
  int K, warps, rows_per_sm;
};

// Warps per block that keep the most rows in flight per SM (the fewest
// warps among equals: a block holds its shared memory until its slowest
// row is done); 0 warps if one row does not fit.  Each device keeps the
// last K's result: callers launch at one K again and again.
cudaError_t pick_config(int K, int device, Config* c) {
  static int optin[64] = {0};
  static Config last[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (last[device].warps > 0 && last[device].K == K) {
    *c = last[device];
    return cudaSuccess;
  }
  cudaError_t err;
  if (optin[device] == 0) {
    int bytes = 0;
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(alias_build_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        alias_build_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    optin[device] = bytes;
  }
  const size_t row_bytes = (size_t)row_words(K) * sizeof(float);
  *c = Config{K, 0, 0};
  for (int w = 1; w <= 8; w *= 2) {
    if (w * row_bytes > (size_t)optin[device]) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, alias_build_kernel, w * kWarp, w * row_bytes);
    if (err != cudaSuccess) return err;
    if (blocks * w > c->rows_per_sm) {
      c->rows_per_sm = blocks * w;
      c->warps = w;
    }
  }
  last[device] = *c;
  return cudaSuccess;
}

}  // namespace

// Warps per block and rows in flight per SM that a launch at this K uses.
extern "C" int alias_build_config(int K, int device, int* warps,
                                  int* rows_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Config c{K, 0, 0};
  err = pick_config(K, device, &c);
  *warps = c.warps;
  *rows_per_sm = c.rows_per_sm;
  return (int)err;
}

extern "C" int alias_build_launch(const void* weights, void* prob,
                                  void* alias, int V, int K, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Config c{K, 0, 0};
  err = pick_config(K, device, &c);
  if (err != cudaSuccess) return (int)err;
  if (c.warps == 0) return (int)cudaErrorInvalidValue;  // a row does not fit
  const size_t smem = (size_t)c.warps * row_words(K) * sizeof(float);
  const int blocks = (V + c.warps - 1) / c.warps;
  alias_build_kernel<<<blocks, c.warps * kWarp, smem,
                       (cudaStream_t)stream>>>(
      (const float*)weights, (float*)prob, (int*)alias, V, K);
  return (int)cudaGetLastError();
}

extern "C" const char* alias_build_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
