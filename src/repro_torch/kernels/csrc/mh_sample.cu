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
// word index w, ndk rows by its document index d, no [T, K] pre-gather and
// no K padding.  The chain's state only ever takes one of 1 + 2 mh_steps
// candidate topics: z0, each step's word proposal and each step's doc
// proposal.  Every factor the chain needs -- p(k) (its -dw correction
// depends only on k == z0), q_word(k), q_doc(k) -- is a function of the
// candidate alone.  So for mh_steps <= 4 the kernel issues every load in
// three dependent levels: (1) the token's streams and every step's
// randoms; (2) aprob/aalias at each step's bucket, and n_wk/n_dk/n_k at z0
// and at each doc proposal; (3) the same three at each word proposal.  It
// computes the three factors of each candidate in registers, and the chain
// becomes register selects.  More steps take a loop that loads in chain
// order.  n_k is read through the read-only data path (__ldg).  The other
// choice, n_k staged in shared memory, makes every one of the small blocks
// below load all K entries and wait at a barrier before its first gather:
// measured on the card it was 1.4-2.1x slower at serving's and the
// snapshot group's shapes and no faster at the pipelined group's (PERF.md).
//
// Launch.  The block size comes from T and the SM count: 256 threads,
// halved (down to 32) while that leaves fewer than two blocks per SM, so a
// training group's 8,192 tokens reach every SM.
//
// Bound.  Gathers: about ten scattered 4-byte reads per token per MH step,
// each in a 32-byte sector, plus the per-token streams; the arithmetic is a
// few dozen flops per step.  Tokens of one word or document share sectors,
// so the least traffic is the distinct sectors the chain reads: the kernel
// is bound by memory sectors, and latency-bound at the group sizes of the
// main path (one short wave).
//
// Parity.  The result must equal the plain version bitwise, so:
//   * build with --fmad=false: u*K then (u*K - bucket) must not fuse;
//   * no fast math: fp32 '/' is IEEE div_rn;
//   * each factor is the plain version's expression in its order:
//     ((ndk - e + alpha) * (nwk - e_wk + beta)) / (nk - e_wk + vbeta), and
//     (p(z') q(z)) / (max(p(z),1e-30) max(q(z'),1e-30)); computing it once
//     per candidate gives the same float as computing it at each use;
//   * vbeta = V*beta arrives rounded once, from double, as JAX rounds it;
//   * max() keeps a NaN operand as jnp.maximum / torch.clamp_min do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const int* z0;
  const int* w;
  const int* d;
  const float* nwk;
  const int* ndk;
  const float* nk;
  const float* aprob;
  const int* aalias;
  const float* u_word;
  const float* u_waccept;
  const int* z_doc;
  const float* u_daccept;
  int* z_out;
  int T, K, steps;
  float alpha, beta, vbeta;
  int frozen;
};

__device__ __forceinline__ float max_floor(float x) {
  // jnp.maximum(x, 1e-30) / torch.clamp_min: a NaN stays NaN
  return (x < 1e-30f) ? 1e-30f : x;
}

// The three factors of one candidate topic k, from its n_wk, n_dk, n_k.
struct Factors {
  float p, qw, qd;
};

__device__ __forceinline__ Factors factors(const Params& a, int k, int z0,
                                           float nwk_k, int ndk_k,
                                           float nk_k) {
  const float e = (k == z0) ? 1.0f : 0.0f;
  const float e_wk = a.frozen ? 0.0f : e;
  const float x = ((float)ndk_k - e) + a.alpha;
  const float y = (nwk_k - e_wk) + a.beta;
  const float c = (nk_k - e_wk) + a.vbeta;
  Factors f;
  f.p = (x * y) / c;
  f.qw = (nwk_k + a.beta) / (nk_k + a.vbeta);
  f.qd = (float)ndk_k + a.alpha;
  return f;
}

// mh_steps == STEPS (1..4): every load in three levels, the chain in
// registers.
template <int STEPS>
__global__ void mh_sample_kernel(Params a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.T) return;

  // level 1: the token's streams
  const int zt0 = a.z0[t];
  const float* nwk_w = a.nwk + (int64_t)a.w[t] * a.K;
  const float* aprob_w = a.aprob + (int64_t)a.w[t] * a.K;
  const int* aalias_w = a.aalias + (int64_t)a.w[t] * a.K;
  const int* ndk_d = a.ndk + (int64_t)a.d[t] * a.K;
  float uw[STEPS], uwa[STEPS], uda[STEPS];
  int zd[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int64_t at = (int64_t)s * a.T + t;
    uw[s] = a.u_word[at];
    uwa[s] = a.u_waccept[at];
    zd[s] = a.z_doc[at];
    uda[s] = a.u_daccept[at];
  }

  // level 2: the alias entries at each bucket; the counts at z0 and at
  // each doc proposal
  const float kf = (float)a.K;
  int bucket[STEPS];
  float coin[STEPS], ap[STEPS];
  int aa[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const float scaled = uw[s] * kf;
    int b = (int)scaled;
    b = b < a.K - 1 ? b : a.K - 1;
    bucket[s] = b;
    coin[s] = scaled - (float)b;
    ap[s] = aprob_w[b];
    aa[s] = aalias_w[b];
  }
  const float nwk0 = nwk_w[zt0];
  const int ndk0 = ndk_d[zt0];
  const float nk0 = __ldg(a.nk + zt0);
  float nwkd[STEPS], nkd[STEPS];
  int ndkd[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    nwkd[s] = nwk_w[zd[s]];
    ndkd[s] = ndk_d[zd[s]];
    nkd[s] = __ldg(a.nk + zd[s]);
  }

  // level 3: the counts at each word proposal
  int zw[STEPS];
  float nwkw[STEPS], nkw[STEPS];
  int ndkw[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    zw[s] = (coin[s] < ap[s]) ? bucket[s] : aa[s];
    nwkw[s] = nwk_w[zw[s]];
    ndkw[s] = ndk_d[zw[s]];
    nkw[s] = __ldg(a.nk + zw[s]);
  }

  // the chain: register selects among the candidates' factors
  int z = zt0;
  Factors fz = factors(a, zt0, zt0, nwk0, ndk0, nk0);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const Factors fw = factors(a, zw[s], zt0, nwkw[s], ndkw[s], nkw[s]);
    float ratio = (fw.p * fz.qw) / (max_floor(fz.p) * max_floor(fw.qw));
    if (uwa[s] < ratio) {
      z = zw[s];
      fz = fw;
    }
    const Factors fd = factors(a, zd[s], zt0, nwkd[s], ndkd[s], nkd[s]);
    ratio = (fd.p * fz.qd) / (max_floor(fz.p) * max_floor(fd.qd));
    if (uda[s] < ratio) {
      z = zd[s];
      fz = fd;
    }
  }
  a.z_out[t] = z;
}

// Any mh_steps: the chain in order, each step's loads after the last's.
__global__ void mh_sample_loop_kernel(Params a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.T) return;

  const int zt0 = a.z0[t];
  const int64_t wrow = (int64_t)a.w[t] * a.K;
  const float* nwk_w = a.nwk + wrow;
  const int* ndk_d = a.ndk + (int64_t)a.d[t] * a.K;
  auto at_k = [&](int k) {
    return factors(a, k, zt0, nwk_w[k], ndk_d[k], __ldg(a.nk + k));
  };

  const float kf = (float)a.K;
  int z = zt0;
  Factors fz = at_k(zt0);
  for (int s = 0; s < a.steps; ++s) {
    const int64_t at = (int64_t)s * a.T + t;
    const float scaled = a.u_word[at] * kf;
    int bucket = (int)scaled;
    bucket = bucket < a.K - 1 ? bucket : a.K - 1;
    const float coin = scaled - (float)bucket;
    const int zp_w = (coin < a.aprob[wrow + bucket]) ? bucket
                                                     : a.aalias[wrow + bucket];
    const Factors fw = at_k(zp_w);
    float ratio = (fw.p * fz.qw) / (max_floor(fz.p) * max_floor(fw.qw));
    if (a.u_waccept[at] < ratio) {
      z = zp_w;
      fz = fw;
    }
    const int zp_d = a.z_doc[at];
    const Factors fd = at_k(zp_d);
    ratio = (fd.p * fz.qd) / (max_floor(fz.p) * max_floor(fd.qd));
    if (a.u_daccept[at] < ratio) {
      z = zp_d;
      fz = fd;
    }
  }
  a.z_out[t] = z;
}

void* pick_kernel(int steps) {
  switch (steps) {
    case 1: return (void*)mh_sample_kernel<1>;
    case 2: return (void*)mh_sample_kernel<2>;
    case 3: return (void*)mh_sample_kernel<3>;
    case 4: return (void*)mh_sample_kernel<4>;
    default: return (void*)mh_sample_loop_kernel;
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

extern "C" int mh_sample_launch(
    const void* z0, const void* w, const void* d, const void* nwk,
    const void* ndk, const void* nk, const void* aprob, const void* aalias,
    const void* u_word, const void* u_waccept, const void* z_doc,
    const void* u_daccept, void* z_out, int T, int K, int steps, float alpha,
    float beta, float vbeta, int frozen, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params a{(const int*)z0,        (const int*)w,         (const int*)d,
           (const float*)nwk,     (const int*)ndk,       (const float*)nk,
           (const float*)aprob,   (const int*)aalias,    (const float*)u_word,
           (const float*)u_waccept, (const int*)z_doc,   (const float*)u_daccept,
           (int*)z_out,           T,                     K,
           steps,                 alpha,                 beta,
           vbeta,                 frozen};
  const int sms = sm_count(device);
  int threads = 256;
  while (threads > 32 && (T + threads - 1) / threads < 2 * sms) threads /= 2;
  const int blocks = (T + threads - 1) / threads;
  void* args[] = {&a};
  err = cudaLaunchKernel(pick_kernel(steps), dim3(blocks), dim3(threads),
                         args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* mh_sample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
