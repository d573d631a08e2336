// The MH chain's pre-drawn randoms (MHRandoms) in one launch (sm_90a).
//
// Not a TPU kernel: in the JAX package these draws are jax.random calls that
// XLA fuses into the jitted sweep, outside any Pallas kernel.  Eagerly, the
// port issued them as ~2,100 small tensor ops per training group.  Two entry
// points, each writing all four [mh_steps, B] arrays:
//
//   * mh_draws_train: lightlda.draw_mh_randoms(key, make_doc_draw(d_b,
//     z_snapshot, doc_start, doc_len, cfg), B, cfg) for one group or block.
//     u_word, u_waccept, u_daccept at counter s*B+i from split(key, 4)'s
//     0th, 1st and 3rd keys; the doc draw from the step keys
//     split(split(split(key, 4)[2], S)[s], 3): pos from uniform(k1),
//     randint(k2, 0, K) from split(k2, 2)'s two words, use_tok from
//     uniform(k3), each at counter i;
//   * mh_draws_foldin: infer/foldin._doc_randoms(fold_in(doc_keys, sweep),
//     z, nd, cfg) for a [B, L] batch, written in the [S, B*L] layout the
//     chain reads: per document, split(fold_in(key, sweep), 4), the doc
//     keys split(kd, 3) (no per-step split) and counters m*L+l.
//
// Design.  jax's threefry2x32, 20 rounds, in uint32 registers (rotations
// by funnel shift).  A block derives the few keys it needs into shared
// memory first, one chain of at most four hashes per thread, in parallel
// over threads; then each thread draws its element's steps.  The training
// kernel walks B with a grid-stride loop over at most 8 blocks per SM, so
// the key derivation runs once per resident block, not once per element.
//
// Bound.  Integer work: seven hashes per element and step, each 20 rounds
// of add, rotate and xor (60 int32 operations; the key injections fold
// into three-input adds), at the card's 64 int32 lanes per SM per clock;
// the bytes are 16 per element and step written, plus the per-token
// reads.  The arithmetic bounds it (PERF.md shows the sums).
//
// Parity.  Bitwise against the plain composition (kernels/ref.py):
//   * uniform is ((bits >> 9) | 0x3F800000) read as a float, minus 1.0f;
//   * nd + K*alpha: K*alpha arrives as a float rounded once from the
//     double, as PyTorch rounds a Python scalar before a float32 add;
//   * pos is the product truncated toward zero, then min(pos, max(nd-1, 0));
//   * randint's reduction wraps in uint32, as rng.randint does;
//   * built with --fmad=false; nothing here would fuse, but it stays the
//     rule for every kernel of the port.
// z_snapshot (z) is read only where the draw takes the token branch, which
// never happens for an empty document (u * (0 + K*alpha) < 0 is false).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kThreads = 256;
constexpr int kMaxSteps = (kThreads - 3) / 4;  // 4 step keys + 3 shared

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// jax prng._threefry2x32_lowering for one counter pair.
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k0 = k.a, k1 = k.b, k2 = k.a ^ k.b ^ kParity;
  x0 += k0;
  x1 += k1;
#define ROUND(r) \
  x0 += x1;      \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef ROUND
  return {x0, x1};
}

// split(key, n)[i] and fold_in(key, i): threefry(key, (0, i)).
__device__ __forceinline__ Key child(Key k, uint32_t i) {
  return threefry(k, 0u, i);
}

// 32 random bits at flat position n of a sample shape.
__device__ __forceinline__ uint32_t bits(Key k, unsigned long long n) {
  const Key r = threefry(k, (uint32_t)(n >> 32), (uint32_t)n);
  return r.a ^ r.b;
}

__device__ __forceinline__ float uniform(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// rng.randint(k2, shape, 0, K) from split(k2, 2)'s two words.
__device__ __forceinline__ int randint(uint32_t higher, uint32_t lower,
                                       uint32_t span, uint32_t mult) {
  return (int)(((higher % span) * mult + lower % span) % span);
}

// The doc keys of one step: k1, split(k2, 2)[0], split(k2, 2)[1], k3,
// from the step key ks; thread j of four computes the j-th.
__device__ __forceinline__ Key doc_key(Key ks, int j) {
  if (j == 0) return child(ks, 0u);
  if (j == 3) return child(ks, 2u);
  return child(child(ks, 1u), (uint32_t)(j - 1));
}

struct TrainParams {
  const long long* key;  // [2]: the group's key, uint32 words in int64
  const int* d;          // [B] document of each slot
  const int* z_snap;     // [N] assignments the doc draw reads
  const int* doc_start;  // [D]
  const int* doc_len;    // [D]
  float* u_word;         // [S, B]
  float* u_waccept;
  int* z_doc;
  float* u_daccept;
  long long B;
  int steps;
  uint32_t K;
  float kalpha;  // K * alpha, rounded to float once
  uint32_t mult;  // (2^16 mod K)^2 mod K
};

__global__ void __launch_bounds__(kThreads)
    mh_draws_train_kernel(TrainParams p) {
  // [kw, kwa, kda] then per step [k1, k2 higher, k2 lower, k3]
  __shared__ Key sk[3 + 4 * kMaxSteps];
  const int t = threadIdx.x;
  const Key key{(uint32_t)p.key[0], (uint32_t)p.key[1]};
  if (t < 3) {
    sk[t] = child(key, t == 2 ? 3u : (uint32_t)t);
  } else if (t < 3 + 4 * p.steps) {
    const int s = (t - 3) >> 2;
    const Key ks = child(child(key, 2u), (uint32_t)s);  // split(kd, S)[s]
    sk[t] = doc_key(ks, (t - 3) & 3);
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + t; i < p.B;
       i += stride) {
    const int d = p.d[i];
    const int len = p.doc_len[d];
    const int start = p.doc_start[d];
    const float nd = (float)len;
    const float ndc = fmaxf(nd, 1.0f);
    const int pos_max = max((int)nd - 1, 0);
    const float denom = nd + p.kalpha;
    const unsigned long long ui = (unsigned long long)i;
    for (int s = 0; s < p.steps; ++s) {
      const unsigned long long n = (unsigned long long)s * p.B + ui;
      p.u_word[n] = uniform(bits(sk[0], n));
      p.u_waccept[n] = uniform(bits(sk[1], n));
      p.u_daccept[n] = uniform(bits(sk[2], n));
      const Key* ks = sk + 3 + 4 * s;
      const int pos = min((int)(uniform(bits(ks[0], ui)) * ndc), pos_max);
      const int z_unif = randint(bits(ks[1], ui), bits(ks[2], ui), p.K, p.mult);
      const bool use_tok = uniform(bits(ks[3], ui)) * denom < nd;
      p.z_doc[n] = use_tok ? p.z_snap[start + pos] : z_unif;
    }
  }
}

struct FoldParams {
  const long long* keys;  // [B, 2] per-document keys
  const int* z;           // [B, L]
  const int* nd;          // [B] valid tokens per document
  float* u_word;          // [S, B*L]
  float* u_waccept;
  int* z_doc;
  float* u_daccept;
  int B, L, steps, sweep;
  uint32_t K;
  float kalpha;
  uint32_t mult;
};

__global__ void __launch_bounds__(kThreads)
    mh_draws_foldin_kernel(FoldParams p) {
  // kw, kwa, kda, k1, k2 higher, k2 lower, k3 of this block's document
  __shared__ Key sk[7];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  if (t < 7) {
    const Key doc{(uint32_t)p.keys[2 * b], (uint32_t)p.keys[2 * b + 1]};
    const Key sw = child(doc, (uint32_t)p.sweep);  // fold_in(key, sweep)
    sk[t] = t < 3 ? child(sw, t == 2 ? 3u : (uint32_t)t)
                  : doc_key(child(sw, 2u), t - 3);
  }
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + t;
  if (l >= p.L) return;
  const int len = p.nd[b];
  const float nd = (float)len;
  const float ndc = fmaxf(nd, 1.0f);
  const int pos_max = max(len - 1, 0);
  const float denom = nd + p.kalpha;
  const long long bl = (long long)p.B * p.L;
  const int* zrow = p.z + (long long)b * p.L;
  for (int m = 0; m < p.steps; ++m) {
    const unsigned long long c = (unsigned long long)m * p.L + l;
    const long long o = m * bl + (long long)b * p.L + l;
    p.u_word[o] = uniform(bits(sk[0], c));
    p.u_waccept[o] = uniform(bits(sk[1], c));
    p.u_daccept[o] = uniform(bits(sk[2], c));
    const int pos = min((int)(uniform(bits(sk[3], c)) * ndc), pos_max);
    const int z_unif = randint(bits(sk[4], c), bits(sk[5], c), p.K, p.mult);
    const bool use_tok = uniform(bits(sk[6], c)) * denom < nd;
    p.z_doc[o] = use_tok ? zrow[pos] : z_unif;
  }
}

int sm_count(int device) {
  static int cache[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cache[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                               device) == cudaSuccess)
      cache[device] = n;
  }
  return cache[device];
}

}  // namespace

extern "C" int mh_draws_train_launch(
    const void* key, const void* d, const void* z_snap, const void* doc_start,
    const void* doc_len, void* u_word, void* u_waccept, void* z_doc,
    void* u_daccept, long long B, int steps, int K, float kalpha,
    unsigned int mult, int device, void* stream) {
  if (steps < 1 || steps > kMaxSteps || K < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  TrainParams a{(const long long*)key, (const int*)d, (const int*)z_snap,
                (const int*)doc_start, (const int*)doc_len, (float*)u_word,
                (float*)u_waccept,     (int*)z_doc,   (float*)u_daccept,
                B,                     steps,         (uint32_t)K,
                kalpha,                (uint32_t)mult};
  const long long need = (B + kThreads - 1) / kThreads;
  const long long cap = 8LL * (sm_count(device) > 0 ? sm_count(device) : 132);
  const int blocks = (int)(need < cap ? need : cap);
  void* args[] = {&a};
  err = cudaLaunchKernel((const void*)mh_draws_train_kernel, dim3(blocks),
                         dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int mh_draws_foldin_launch(
    const void* keys, const void* z, const void* nd, void* u_word,
    void* u_waccept, void* z_doc, void* u_daccept, int B, int L, int steps,
    int sweep, int K, float kalpha, unsigned int mult, int device,
    void* stream) {
  if (steps < 1 || K < 1 || B < 1 || L < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FoldParams a{(const long long*)keys, (const int*)z, (const int*)nd,
               (float*)u_word, (float*)u_waccept, (int*)z_doc,
               (float*)u_daccept, B, L, steps, sweep, (uint32_t)K, kalpha,
               (uint32_t)mult};
  int threads = 128;
  while (threads > 32 && threads / 2 >= L) threads /= 2;
  void* args[] = {&a};
  err = cudaLaunchKernel((const void*)mh_draws_foldin_kernel,
                         dim3((L + threads - 1) / threads, B), dim3(threads),
                         args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* mh_draws_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
