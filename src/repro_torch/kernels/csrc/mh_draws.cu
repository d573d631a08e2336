// jax's threefry2x32 draws of the LDA paths, each in one launch (sm_90a).
//
// Not a TPU kernel: in the JAX package these draws are jax.random calls that
// XLA fuses into the jitted sweep, outside any Pallas kernel.  Issued eagerly
// as int64 tensor ops they cost hundreds of launches each.  Four entry
// points share one hash:
//
//   * mh_draws_train: lightlda.draw_mh_randoms(key, make_doc_draw(d_b,
//     z_snapshot, doc_start, doc_len, cfg), B, cfg, stride) for one group
//     or block: B slots written as [S, B], u_word, u_waccept, u_daccept at
//     counter s*stride+i (stride >= B; B where the slots are the whole
//     row, more where they are a row's valid prefix) from split(key, 4)'s
//     0th, 1st and 3rd keys; the doc draw from the step keys
//     split(split(split(key, 4)[2], S)[s], 3): pos from uniform(k1),
//     randint(k2, 0, K) from split(k2, 2)'s two words, use_tok from
//     uniform(k3), each at counter i;
//   * mh_draws_foldin: infer/foldin._doc_randoms(fold_in(doc_keys, sweep),
//     z, nd, cfg) for a [B, L] batch, written in the [S, B*L] layout the
//     chain reads: per document, split(fold_in(key, sweep), 4), the doc
//     keys split(kd, 3) (no per-step split) and counters m*L+l;
//   * threefry_keys: rng.split(fold_in(...fold_in(keys, d0)..., dn), num)
//     over a batch of keys, or the fold-in chain alone (num = 0);
//   * threefry_randint: rng.randint(fold_in(...(keys, d0)..., dn), shape,
//     minval, maxval) over a batch of keys, both words of bits and the
//     uint32 modular reduction.
//
// Design.  jax's threefry2x32, 20 rounds, in uint32 registers (rotations
// by funnel shift).  The draws' keys are chains of up to four dependent
// hashes; a block derives the few it needs into shared memory first, all
// chains in parallel over its threads, so their latency is one short
// prologue.  The training kernel then takes one of two layouts, by the
// work it is given:
//   * split, where a thread per slot would not fill a wave of blocks (a
//     snapshot group of 8,192 slots gave 32 blocks on 132 SMs): a work
//     item is a tile of 128 slots at one step, and each slot two threads,
//     the block's first four warps drawing its three uniforms (three
//     hashes), the last four its doc proposal (four hashes and the
//     gathers), so 8,192 slots at two steps give 128 blocks of 8 warps;
//   * whole, where the slots alone fill the card (pipelined groups, tiered
//     blocks, a stream's blocked groups): a thread per slot draws all of
//     its steps, its document read once, as this kernel did before the
//     split; a split layout ran slower at these sizes, its per-item index
//     arithmetic and reloads costing more than the spreading gains.
// Each warp stores 128 consecutive floats or ints of one [S, N] row in
// both.  The grid is one wave of resident blocks (the occupancy the
// compiler allows) looping over the work, or two waves where the work
// exceeds two.  The fold-in grid is (tile, document, step), split the same
// way.  threefry_keys takes a thread per output key; threefry_randint a
// thread per element, after its block derives split(key, 2).
//
// Bound.  Integer work: seven hashes per element and step, each 20 rounds
// of add, rotate and xor (60 int32 operations; the key injections fold
// into three-input adds), at the card's 64 int32 lanes per SM per clock;
// the bytes are 16 per element and step written, plus the per-token
// reads.  The arithmetic bounds all four (randint: two hashes, 120
// operations, per 4-byte value); threefry_keys at the paths' shapes is a
// launch.  PERF.md shows the sums.
//
// Parity.  Bitwise against the plain composition (kernels/ref.py):
//   * uniform is ((bits >> 9) | 0x3F800000) read as a float, minus 1.0f;
//   * nd + K*alpha: K*alpha arrives as a float rounded once from the
//     double, as PyTorch rounds a Python scalar before a float32 add;
//   * pos is the product truncated toward zero, then min(pos, max(nd-1, 0));
//   * randint's reduction wraps in uint32, as rng.randint does, and adds
//     minval modulo 2^32 as the plain version's cast to int32 does;
//   * built with --fmad=false; nothing here would fuse, but it stays the
//     rule for every kernel of the port.
// z_snapshot (z) is read only where the draw takes the token branch, which
// never happens for an empty document (u * (0 + K*alpha) < 0 is false).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kTile = 128;             // elements of a draws tile
constexpr int kThreads = 2 * kTile;    // a uniforms half, a doc half
constexpr int kMaxSteps = 63;
constexpr int kMaxChain = 8;           // fold_in data of one key chain
constexpr int kKeyThreads = 128;
constexpr int kRandThreads = 256;

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

// rng.randint's offset in [0, span) from split(k, 2)'s two words of bits.
__device__ __forceinline__ uint32_t randint(uint32_t higher, uint32_t lower,
                                            uint32_t span, uint32_t mult) {
  return ((higher % span) * mult + lower % span) % span;
}

__device__ __forceinline__ Key load_key(const long long* keys, long long b) {
  return {(uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1]};
}

// The doc keys of one step: k1, split(k2, 2)[0], split(k2, 2)[1], k3,
// from the step key ks; thread j of four computes the j-th.
__device__ __forceinline__ Key doc_key(Key ks, int j) {
  if (j == 0) return child(ks, 0u);
  if (j == 3) return child(ks, 2u);
  return child(child(ks, 1u), (uint32_t)(j - 1));
}

// What the doc proposal reads of a slot's document, once for all steps.
struct Doc {
  float nd, ndc, denom;  // length, max(length, 1), length + K*alpha
  int pos_max;           // max(length - 1, 0)
  int start;             // the document's first token in z
};

__device__ __forceinline__ Doc doc_of(int len, float kalpha, int start) {
  const float nd = (float)len;
  return {nd, fmaxf(nd, 1.0f), nd + kalpha, max(len - 1, 0), start};
}

// The doc proposal at counter c: pos from k[0], randint from k[1] and
// k[2], use_tok from k[3]; z holds the assignments the draw reads.
__device__ __forceinline__ int doc_draw(const Key* k, unsigned long long c,
                                        const Doc& doc, const int* z,
                                        uint32_t K, uint32_t mult) {
  const int pos = min((int)(uniform(bits(k[0], c)) * doc.ndc), doc.pos_max);
  const int z_unif = (int)randint(bits(k[1], c), bits(k[2], c), K, mult);
  const bool use_tok = uniform(bits(k[3], c)) * doc.denom < doc.nd;
  return use_tok ? z[doc.start + pos] : z_unif;
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
  long long stride;  // the counters' row length, >= B
  int steps;
  int tiles_per_step;  // ceil(B / kTile)
  bool whole;          // a thread per slot, every draw of it
  uint32_t K;
  float kalpha;  // K * alpha, rounded to float once
  uint32_t mult;  // (2^16 mod K)^2 mod K
};

__global__ void __launch_bounds__(kThreads)
    mh_draws_train_kernel(TrainParams p) {
  // [kw, kwa, kda] then per step [k1, k2 higher, k2 lower, k3]
  __shared__ Key sk[3 + 4 * kMaxSteps];
  const Key key = load_key(p.key, 0);
  for (int t = threadIdx.x; t < 3 + 4 * p.steps; t += kThreads) {
    if (t < 3) {
      sk[t] = child(key, t == 2 ? 3u : (uint32_t)t);
    } else {
      const int s = (t - 3) >> 2;
      const Key ks = child(child(key, 2u), (uint32_t)s);  // split(kd, S)[s]
      sk[t] = doc_key(ks, (t - 3) & 3);
    }
  }
  __syncthreads();
  if (p.whole) {
    // the loop this kernel ran before the split layout, as it was: the
    // same draws through doc_draw compiled to a slower loop here
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < p.B; i += stride) {
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
        const unsigned long long c = (unsigned long long)s * p.stride + ui;
        p.u_word[n] = uniform(bits(sk[0], c));
        p.u_waccept[n] = uniform(bits(sk[1], c));
        p.u_daccept[n] = uniform(bits(sk[2], c));
        const Key* ks = sk + 3 + 4 * s;
        const int pos = min((int)(uniform(bits(ks[0], ui)) * ndc), pos_max);
        const int z_unif =
            (int)randint(bits(ks[1], ui), bits(ks[2], ui), p.K, p.mult);
        const bool use_tok = uniform(bits(ks[3], ui)) * denom < nd;
        p.z_doc[n] = use_tok ? p.z_snap[start + pos] : z_unif;
      }
    }
    return;
  }
  // split: a work item is a tile of slots at one step; warps 0-3 draw its
  // uniforms, warps 4-7 its doc proposals
  const bool half = threadIdx.x >= kTile;
  const int lane = threadIdx.x - (half ? kTile : 0);
  const int items = p.tiles_per_step * p.steps;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int s = item / p.tiles_per_step;
    const long long i =
        (long long)(item - s * p.tiles_per_step) * kTile + lane;
    if (i >= p.B) continue;
    const unsigned long long n = (unsigned long long)s * p.B + i;
    if (!half) {
      const unsigned long long c = (unsigned long long)s * p.stride + i;
      p.u_word[n] = uniform(bits(sk[0], c));
      p.u_waccept[n] = uniform(bits(sk[1], c));
      p.u_daccept[n] = uniform(bits(sk[2], c));
    } else {
      const int d = p.d[i];
      p.z_doc[n] = doc_draw(sk + 3 + 4 * s, (unsigned long long)i,
                            doc_of(p.doc_len[d], p.kalpha, p.doc_start[d]),
                            p.z_snap, p.K, p.mult);
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
  int B, L, sweep, tile;  // tile: elements a block takes (32, 64 or 128)
  uint32_t K;
  float kalpha;
  uint32_t mult;
};

__global__ void __launch_bounds__(kThreads)
    mh_draws_foldin_kernel(FoldParams p) {
  // kw, kwa, kda, k1, k2 higher, k2 lower, k3 of this block's document
  __shared__ Key sk[7];
  const int b = blockIdx.y;
  const int m = blockIdx.z;  // the step
  const int t = threadIdx.x;
  if (t < 7) {
    const Key sw = child(load_key(p.keys, b), (uint32_t)p.sweep);  // fold_in
    sk[t] = t < 3 ? child(sw, t == 2 ? 3u : (uint32_t)t)
                  : doc_key(child(sw, 2u), t - 3);
  }
  __syncthreads();
  const bool half = t >= p.tile;  // the second half: the doc proposal
  const int l = blockIdx.x * p.tile + t - (half ? p.tile : 0);
  if (l >= p.L) return;
  const unsigned long long c = (unsigned long long)m * p.L + l;
  const long long o = ((long long)m * p.B + b) * p.L + l;
  if (!half) {
    p.u_word[o] = uniform(bits(sk[0], c));
    p.u_waccept[o] = uniform(bits(sk[1], c));
    p.u_daccept[o] = uniform(bits(sk[2], c));
  } else {
    p.z_doc[o] = doc_draw(sk + 3, c, doc_of(p.nd[b], p.kalpha, 0),
                          p.z + (long long)b * p.L, p.K, p.mult);
  }
}

struct Chain {
  uint32_t data[kMaxChain];
  int n;
};

__device__ __forceinline__ Key fold_chain(Key k, const Chain& c) {
  for (int j = 0; j < c.n; ++j) k = child(k, c.data[j]);
  return k;
}

struct KeysParams {
  const long long* keys;  // [nkeys, 2]
  long long* out;         // [nkeys, num, 2], or [nkeys, 2] when num == 0
  long long nkeys;
  int num;
  Chain chain;
};

__global__ void __launch_bounds__(kKeyThreads)
    threefry_keys_kernel(KeysParams p) {
  const int per = p.num > 0 ? p.num : 1;
  const long long t = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
  if (t >= p.nkeys * per) return;
  const long long b = t / per;
  Key k = fold_chain(load_key(p.keys, b), p.chain);
  if (p.num > 0) k = child(k, (uint32_t)(t - b * per));
  p.out[2 * t] = (long long)k.a;
  p.out[2 * t + 1] = (long long)k.b;
}

struct RandintParams {
  const long long* keys;  // [nkeys, 2]
  int* out;               // [nkeys, m]
  long long m;            // elements of the sample shape
  long long tiles_per_key;
  Chain chain;
  uint32_t span, mult, minval;
};

__global__ void __launch_bounds__(kRandThreads)
    threefry_randint_kernel(RandintParams p) {
  __shared__ Key sk[2];  // split(key, 2): the higher and lower words' keys
  const long long b = blockIdx.x / p.tiles_per_key;
  const long long n =
      (blockIdx.x - b * p.tiles_per_key) * kRandThreads + threadIdx.x;
  if (threadIdx.x < 2)
    sk[threadIdx.x] =
        child(fold_chain(load_key(p.keys, b), p.chain), threadIdx.x);
  __syncthreads();
  if (n >= p.m) return;
  const uint32_t off = randint(bits(sk[0], n), bits(sk[1], n), p.span,
                               p.mult);
  p.out[b * p.m + n] = (int)(off + p.minval);
}

// Blocks of the training kernel resident on the whole card at once: its
// occupancy per SM times the SMs (cached per device; 0 if a query fails).
long long train_wave(int device) {
  static long long cache[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mh_draws_train_kernel, kThreads, 0) == cudaSuccess)
      cache[device] = (long long)sms * per_sm;
  }
  return cache[device];
}

cudaError_t finish(cudaError_t err) {
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool chain_of(const unsigned int* data, int n, Chain* c) {
  if (n < 0 || n > kMaxChain || (n > 0 && data == nullptr)) return false;
  c->n = n;
  for (int j = 0; j < kMaxChain; ++j) c->data[j] = j < n ? data[j] : 0u;
  return true;
}

}  // namespace

extern "C" int mh_draws_train_launch(
    const void* key, const void* d, const void* z_snap, const void* doc_start,
    const void* doc_len, void* u_word, void* u_waccept, void* z_doc,
    void* u_daccept, long long B, long long stride, int steps, int K,
    float kalpha, unsigned int mult, int device, void* stream) {
  const long long per_step = (B + kTile - 1) / kTile;
  if (steps < 1 || steps > kMaxSteps || K < 1 || B < 1 || stride < B ||
      per_step * steps > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long wave = train_wave(device);
  if (wave < 1) return (int)cudaErrorInvalidDevice;
  // A thread per slot where that fills a wave of blocks, else the split
  // items; the grid is one wave, or two where the work exceeds two (the
  // block scheduler then evens the SMs' shares out).
  const long long slot_blocks = (B + kThreads - 1) / kThreads;
  const bool whole = slot_blocks >= wave;
  TrainParams a{(const long long*)key, (const int*)d, (const int*)z_snap,
                (const int*)doc_start, (const int*)doc_len, (float*)u_word,
                (float*)u_waccept,     (int*)z_doc,   (float*)u_daccept,
                B,                     stride,        steps,
                (int)per_step,         whole,         (uint32_t)K,
                kalpha,                (uint32_t)mult};
  const long long work = whole ? slot_blocks : per_step * steps;
  const int blocks = (int)(work <= wave ? work : work <= 2 * wave ? wave
                                                                : 2 * wave);
  void* args[] = {&a};
  return (int)finish(cudaLaunchKernel((const void*)mh_draws_train_kernel,
                                      dim3(blocks), dim3(kThreads), args, 0,
                                      (cudaStream_t)stream));
}

extern "C" int mh_draws_foldin_launch(
    const void* keys, const void* z, const void* nd, void* u_word,
    void* u_waccept, void* z_doc, void* u_daccept, int B, int L, int steps,
    int sweep, int K, float kalpha, unsigned int mult, int device,
    void* stream) {
  if (steps < 1 || steps > kMaxSteps || K < 1 || B < 1 || L < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tile = kTile;
  while (tile > 32 && tile / 2 >= L) tile /= 2;
  FoldParams a{(const long long*)keys, (const int*)z, (const int*)nd,
               (float*)u_word, (float*)u_waccept, (int*)z_doc,
               (float*)u_daccept, B, L, sweep, tile, (uint32_t)K, kalpha,
               (uint32_t)mult};
  void* args[] = {&a};
  return (int)finish(cudaLaunchKernel(
      (const void*)mh_draws_foldin_kernel,
      dim3((L + tile - 1) / tile, B, steps), dim3(2 * tile), args, 0,
      (cudaStream_t)stream));
}

extern "C" int threefry_keys_launch(const void* keys, void* out,
                                    long long nkeys, const void* data,
                                    int ndata, int num, int device,
                                    void* stream) {
  KeysParams a{(const long long*)keys, (long long*)out, nkeys, num, {}};
  const long long total = nkeys * (num > 0 ? num : 1);
  const long long blocks = (total + kKeyThreads - 1) / kKeyThreads;
  if (nkeys < 1 || num < 0 || blocks > 0x7FFFFFFFLL ||
      !chain_of((const unsigned int*)data, ndata, &a.chain))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  return (int)finish(cudaLaunchKernel((const void*)threefry_keys_kernel,
                                      dim3((unsigned)blocks),
                                      dim3(kKeyThreads), args, 0,
                                      (cudaStream_t)stream));
}

extern "C" int threefry_randint_launch(const void* keys, void* out,
                                       long long nkeys, long long m,
                                       const void* data, int ndata,
                                       unsigned int span, unsigned int mult,
                                       unsigned int minval, int device,
                                       void* stream) {
  RandintParams a{(const long long*)keys, (int*)out, m, 0, {}, span, mult,
                  minval};
  a.tiles_per_key = (m + kRandThreads - 1) / kRandThreads;
  if (nkeys < 1 || m < 1 || span < 1 ||
      nkeys > 0x7FFFFFFFLL / a.tiles_per_key ||
      !chain_of((const unsigned int*)data, ndata, &a.chain))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  return (int)finish(cudaLaunchKernel(
      (const void*)threefry_randint_kernel,
      dim3((unsigned)(nkeys * a.tiles_per_key)), dim3(kRandThreads), args, 0,
      (cudaStream_t)stream));
}

extern "C" const char* mh_draws_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
