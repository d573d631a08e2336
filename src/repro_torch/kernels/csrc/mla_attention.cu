// Fused causal MLA attention, forward and backward (sm_90a, mma.sync).
//
// Replaces no TPU kernel: the JAX twin leaves attention to XLA
// (repro/models/attention.py reaches no pl.pallas_call).  It was added
// because the eager chunked core (models/attention.py::_attend_chunked)
// kept float32 score tiles in device memory and ran its backward products
// as float32 SIMT GEMMs off the tensor cores.  The work is bounded by the
// tensor cores' half-precision rate: a causal (query, key) pair costs
// 2 (dn + dr + dv) FLOP forward, read from tiles that stay in shared
// memory, far above the card's ~295 FLOP a byte.  So the design is
// FlashAttention-2's: a block owns a query tile of one (row, head), each
// warp 16 of its rows, and walks the key tiles those rows can see, the next
// tiles' cp.async copies in flight in a ring of stages while the warps
// multiply the current one; the scores stay in registers as mma.sync
// accumulators, the softmax is online, and the forward writes only the
// output and each row's log-sum-exp (log2 units).  Blocks are launched
// heaviest first, so the causal triangle's long rows do not finish last.
// A warp skips a key tile that lies wholly after its rows.  At the LM
// cell's shapes the mma.sync products run at ~230 TFLOP/s forward and
// ~300 backward (counting the backward's recomputed and hi + lo products),
// against the card's 989 for wgmma, which this design does not use.
//
// MLA's shapes are used as they are: the query and key are two parts (nope
// of DN columns, rope of DR), and the RoPE key is one row a token for every
// head (k_rope [B, T, DR]), copied into shared memory beside each head's
// k_nope tile, never expanded in device memory; V is DV wide.  Row-major
// tiles in shared memory have 16 bytes of padding a row, so ldmatrix's
// eight row addresses fall in eight different bank groups.
//
// Arithmetic (the plain version's, models/attention._mla_attention_plain):
// scores, running max, running sum and accumulator in float32, the
// unnormalised P rounded to the operands' type before P.V.  The backward
// recomputes P from the log-sum-exp and rounds it likewise for dV; dP and
// dS are float32; dS enters dQ = dS.K and dK = dS^T.Q as two half-precision
// terms, hi = dS rounded and lo = dS - hi rounded (16 significant bits in
// bf16), each product accumulated in float32; D = rowsum(dO * O) reads the
// float32 output the forward saved.  dQ, dK and dV are accumulated over the
// whole row or column in float32 and rounded once; each head's share of
// dk_rope is written in float32 and the wrapper sums the heads before the
// one rounding.
//
// Three kernels: mla_fwd; mla_bwd_dq (a query tile against its key tiles;
// it writes D for its rows), then mla_bwd_dkdv (a key tile, each warp 16
// keys, against the query tiles that see it).  Neither backward kernel uses
// atomics, so the gradients do not depend on scheduling.  Head parts
// (DN, DR, DV) are template arguments; DeepSeek-V2-Lite's (128, 64, 128)
// are instantiated, in bf16 and fp16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int kWarp = 32;
constexpr int kPad = 8;   // elements after each shared-memory row: 16 bytes

// Tiles and the stages of their copy ring (measured on an H100 at B 8,
// T 4,096, H 16; PERF.md):
constexpr int kFwdWarps = 8, kFwdKeys = 64, kFwdStages = 2;  // 128 rows
constexpr int kDqWarps = 8, kDqKeys = 64, kDqStages = 2;     // 128 rows
constexpr int kDkvWarps = 4, kDkvRows = 32, kDkvStages = 2;  // 64 keys

template <typename E> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Elem<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from device to shared memory, or 16 zero bytes where !full
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows of D columns from row r0 of g (row stride ld elements) into s
// (row stride D + kPad); rows at or past seqlen read as zeros
template <int D, int ROWS, int NT, typename E>
__device__ __forceinline__ void load_rows(E* s, const E* g, i64 ld, int r0,
                                          int seqlen) {
  constexpr int C = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < seqlen;
    cp16(smem_u32(s + r * (D + kPad) + c * 8),
         g + (ok ? (i64)(r0 + r) * ld : 0) + c * 8, ok);
  }
}

// the A fragment (16 x 16) of k-step kk from 16 row-major rows at s
template <int SD, typename E>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const E* s, int kk,
                                       int lane) {
  ldsm4(a, smem_u32(s + (lane & 15) * SD + kk * 16 + (lane >> 4) * 8));
}

// the B fragments of two n-tiles (b[0..1], b[2..3]) of k-step kk, B[k][n]
// = s[n][k]: 16 rows of n at s
template <int SD, typename E>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const E* s, int kk,
                                       int lane) {
  ldsm4(b, smem_u32(s + ((lane >> 4) * 8 + (lane & 7)) * SD + kk * 16
                    + ((lane >> 3) & 1) * 8));
}

// the B fragments of two n-tiles, B[k][n] = s[k][n]: 16 rows of k at s,
// the n-tiles' 16 columns from s's first
template <int SD, typename E>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const E* s,
                                        int lane) {
  ldsm4t(b, smem_u32(s + (((lane >> 3) & 1) * 8 + (lane & 7)) * SD
                     + (lane >> 4) * 8));
}

// two accumulator n-tiles (16 x 8 each) as the A fragment of one k-step
template <typename E>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = Elem<E>::pack(c0[0], c0[1]);
  a[1] = Elem<E>::pack(c0[2], c0[3]);
  a[2] = Elem<E>::pack(c1[0], c1[1]);
  a[3] = Elem<E>::pack(c1[2], c1[3]);
}

// the same as hi = rounded and lo = (x - hi) rounded
template <typename E>
__device__ __forceinline__ void acc_to_a2(uint32_t (&hi)[4],
                                          uint32_t (&lo)[4],
                                          const float (&c0)[4],
                                          const float (&c1)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = x[2 * i], b = x[2 * i + 1];
    hi[i] = Elem<E>::pack(a, b);
    lo[i] = Elem<E>::pack(a - Elem<E>::round(a), b - Elem<E>::round(b));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DN, int DR, int DV, int KEYS>
__host__ __device__ constexpr int kv_stage() {
  // elements of one key tile's Kn, Kr and V
  return KEYS * (DN + DR + DV + 3 * kPad);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename E, int DN, int DR, int DV, int NW, int BN, int NS>
__global__ void __launch_bounds__(NW * kWarp, 1)
mla_fwd_kernel(const E* __restrict__ QN, const E* __restrict__ QR,
               const E* __restrict__ KN, const E* __restrict__ KR,
               const E* __restrict__ V, E* __restrict__ O,
               float* __restrict__ O32, float* __restrict__ LSE, int seqlen,
               int H, float qk_scale, bool save) {
  constexpr int BM = 16 * NW, NT = NW * kWarp;
  constexpr int SN = DN + kPad, SR = DR + kPad, SV = DV + kPad;
  constexpr int STAGE = kv_stage<DN, DR, DV, BN>();
  extern __shared__ __align__(16) unsigned char smem[];
  E* sQn = reinterpret_cast<E*>(smem);
  E* sQr = sQn + BM * SN;
  E* sKV = sQr + BM * SR;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int start_m = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const i64 tok = (i64)b * seqlen;
  const E* kn = KN + (tok * H + h) * DN;
  const E* kr = KR + tok * DR;
  const E* v = V + (tok * H + h) * DV;
  const int tiles = (min(start_m + BM, seqlen) + BN - 1) / BN;

  load_rows<DN, BM, NT>(sQn, QN + (tok * H + h) * DN, (i64)H * DN, start_m,
                        seqlen);
  load_rows<DR, BM, NT>(sQr, QR + (tok * H + h) * DR, (i64)H * DR, start_m,
                        seqlen);
  auto load_kv = [&](int j) {
    E* s = sKV + (j % NS) * STAGE;
    load_rows<DN, BN, NT>(s, kn, (i64)H * DN, j * BN, seqlen);
    load_rows<DR, BN, NT>(s + BN * SN, kr, (i64)DR, j * BN, seqlen);
    load_rows<DV, BN, NT>(s + BN * (SN + SR), v, (i64)H * DV, j * BN, seqlen);
  };
  load_kv(0);
  cp_commit();
  for (int j = 1; j < NS - 1; ++j) {
    if (j < tiles) load_kv(j);
    cp_commit();
  }

  const int wrow = start_m + warp * 16;        // the warp's first row
  const int row0 = wrow + g;                   // this thread's: row0, row0+8
  uint32_t qa[DN / 16 + DR / 16][4];
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < tiles; ++j) {
    if (j + NS - 1 < tiles) load_kv(j + NS - 1);
    cp_commit();
    cp_wait<NS - 1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DN / 16; ++kk)
        frag_a<SN>(qa[kk], sQn + warp * 16 * SN, kk, lane);
#pragma unroll
      for (int kk = 0; kk < DR / 16; ++kk)
        frag_a<SR>(qa[DN / 16 + kk], sQr + warp * 16 * SR, kk, lane);
    }
    const int n0 = j * BN;
    if (n0 <= wrow + 15) {
      const E* sKn = sKV + (j % NS) * STAGE;
      const E* sKr = sKn + BN * SN;
      const E* sV = sKr + BN * SR;
      float s[BN / 8][4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DN / 16; ++kk)
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bb[4];
          frag_b<SN>(bb, sKn + np * 16 * SN, kk, lane);
          Elem<E>::mma(s[2 * np], qa[kk], bb[0], bb[1]);
          Elem<E>::mma(s[2 * np + 1], qa[kk], bb[2], bb[3]);
        }
#pragma unroll
      for (int kk = 0; kk < DR / 16; ++kk)
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bb[4];
          frag_b<SR>(bb, sKr + np * 16 * SR, kk, lane);
          Elem<E>::mma(s[2 * np], qa[DN / 16 + kk], bb[0], bb[1]);
          Elem<E>::mma(s[2 * np + 1], qa[DN / 16 + kk], bb[2], bb[3]);
        }
      const bool masked = n0 + BN - 1 > wrow;
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * qk_scale;
          if (masked && n0 + nt * 8 + 2 * t4 + (e & 1) > row0 + (e >> 1) * 8)
            x = -INFINITY;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
          rs[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
      for (int nd = 0; nd < DV / 8; ++nd) {
        acc[nd][0] *= alpha[0];
        acc[nd][1] *= alpha[0];
        acc[nd][2] *= alpha[1];
        acc[nd][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a<E>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < DV / 16; ++nd) {
          uint32_t bb[4];
          frag_bt<SV>(bb, sV + kk * 16 * SV + nd * 16, lane);
          Elem<E>::mma(acc[2 * nd], pa, bb[0], bb[1]);
          Elem<E>::mma(acc[2 * nd + 1], pa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // the ring refills this stage next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + r * 8;
    const float l = quad_sum(l_r[r]);
    if (m >= seqlen) continue;
    const i64 off = ((tok + m) * H + h) * DV + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd) {
      const float a0 = acc[nd][2 * r] / l, a1 = acc[nd][2 * r + 1] / l;
      *reinterpret_cast<uint32_t*>(O + off + nd * 8) = Elem<E>::pack(a0, a1);
      if (save)
        *reinterpret_cast<float2*>(O32 + off + nd * 8) = make_float2(a0, a1);
    }
    if (save && t4 == 0) LSE[(i64)bh * seqlen + m] = m_r[r] + log2f(l);
  }
}

// ---------------------------------------------------------------------------
// Backward: dQ (and D)
// ---------------------------------------------------------------------------

template <typename E, int DN, int DR, int DV, int NW, int BN, int NS>
__global__ void __launch_bounds__(NW * kWarp, 1)
mla_bwd_dq_kernel(const E* __restrict__ QN, const E* __restrict__ QR,
                  const E* __restrict__ KN, const E* __restrict__ KR,
                  const E* __restrict__ V, const E* __restrict__ DO,
                  const float* __restrict__ O32,
                  const float* __restrict__ LSE, float* __restrict__ DELTA,
                  E* __restrict__ DQN, E* __restrict__ DQR, int seqlen, int H,
                  float qk_scale, float sm_scale) {
  constexpr int BM = 16 * NW, NT = NW * kWarp;
  constexpr int SN = DN + kPad, SR = DR + kPad, SV = DV + kPad;
  constexpr int STAGE = kv_stage<DN, DR, DV, BN>();
  extern __shared__ __align__(16) unsigned char smem[];
  E* sQn = reinterpret_cast<E*>(smem);
  E* sQr = sQn + BM * SN;
  E* sdO = sQr + BM * SR;
  E* sKV = sdO + BM * SV;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int start_m = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const i64 tok = (i64)b * seqlen;
  const E* kn = KN + (tok * H + h) * DN;
  const E* kr = KR + tok * DR;
  const E* v = V + (tok * H + h) * DV;
  const int tiles = (min(start_m + BM, seqlen) + BN - 1) / BN;

  load_rows<DN, BM, NT>(sQn, QN + (tok * H + h) * DN, (i64)H * DN, start_m,
                        seqlen);
  load_rows<DR, BM, NT>(sQr, QR + (tok * H + h) * DR, (i64)H * DR, start_m,
                        seqlen);
  load_rows<DV, BM, NT>(sdO, DO + (tok * H + h) * DV, (i64)H * DV, start_m,
                        seqlen);
  auto load_kv = [&](int j) {
    E* s = sKV + (j % NS) * STAGE;
    load_rows<DN, BN, NT>(s, kn, (i64)H * DN, j * BN, seqlen);
    load_rows<DR, BN, NT>(s + BN * SN, kr, (i64)DR, j * BN, seqlen);
    load_rows<DV, BN, NT>(s + BN * (SN + SR), v, (i64)H * DV, j * BN, seqlen);
  };
  load_kv(0);
  cp_commit();
  for (int j = 1; j < NS - 1; ++j) {
    if (j < tiles) load_kv(j);
    cp_commit();
  }

  const int wrow = start_m + warp * 16;
  const int row0 = wrow + g;
  // D = rowsum(dO * O) from the float32 output, and the rows' lse
  float dlt[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + r * 8;
    float d = 0.f;
    if (m < seqlen) {
      const i64 off = ((tok + m) * H + h) * DV + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < DV / 8; ++nd) {
        const float2 o = *reinterpret_cast<const float2*>(O32 + off + nd * 8);
        d += Elem<E>::load(DO + off + nd * 8) * o.x
             + Elem<E>::load(DO + off + nd * 8 + 1) * o.y;
      }
    }
    dlt[r] = quad_sum(d);
    lse[r] = m < seqlen ? LSE[(i64)bh * seqlen + m] : 0.f;
    if (m < seqlen && t4 == 0) DELTA[(i64)bh * seqlen + m] = dlt[r];
  }

  float dqn[DN / 8][4], dqr[DR / 8][4];
#pragma unroll
  for (int i = 0; i < DN / 8; ++i)
    dqn[i][0] = dqn[i][1] = dqn[i][2] = dqn[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < DR / 8; ++i)
    dqr[i][0] = dqr[i][1] = dqr[i][2] = dqr[i][3] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    if (j + NS - 1 < tiles) load_kv(j + NS - 1);
    cp_commit();
    cp_wait<NS - 1>();
    __syncthreads();
    const int n0 = j * BN;
    if (n0 <= wrow + 15) {
      const E* sKn = sKV + (j % NS) * STAGE;
      const E* sKr = sKn + BN * SN;
      const E* sV = sKr + BN * SR;
      float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DN / 16; ++kk) {
        uint32_t qa[4];
        frag_a<SN>(qa, sQn + warp * 16 * SN, kk, lane);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bb[4];
          frag_b<SN>(bb, sKn + np * 16 * SN, kk, lane);
          Elem<E>::mma(s[2 * np], qa, bb[0], bb[1]);
          Elem<E>::mma(s[2 * np + 1], qa, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DR / 16; ++kk) {
        uint32_t qa[4];
        frag_a<SR>(qa, sQr + warp * 16 * SR, kk, lane);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bb[4];
          frag_b<SR>(bb, sKr + np * 16 * SR, kk, lane);
          Elem<E>::mma(s[2 * np], qa, bb[0], bb[1]);
          Elem<E>::mma(s[2 * np + 1], qa, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t da[4];
        frag_a<SV>(da, sdO + warp * 16 * SV, kk, lane);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bb[4];
          frag_b<SV>(bb, sV + np * 16 * SV, kk, lane);
          Elem<E>::mma(dp[2 * np], da, bb[0], bb[1]);
          Elem<E>::mma(dp[2 * np + 1], da, bb[2], bb[3]);
        }
      }
      const bool masked = n0 + BN - 1 > wrow;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[nt][e] * qk_scale - lse[e >> 1]);
          if (masked && n0 + nt * 8 + 2 * t4 + (e & 1) > row0 + (e >> 1) * 8)
            p = 0.f;
          s[nt][e] = p * (dp[nt][e] - dlt[e >> 1]);      // dS
        }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t hi[4], lo[4];
        acc_to_a2<E>(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < DN / 16; ++nd) {
          uint32_t bb[4];
          frag_bt<SN>(bb, sKn + kk * 16 * SN + nd * 16, lane);
          Elem<E>::mma(dqn[2 * nd], hi, bb[0], bb[1]);
          Elem<E>::mma(dqn[2 * nd], lo, bb[0], bb[1]);
          Elem<E>::mma(dqn[2 * nd + 1], hi, bb[2], bb[3]);
          Elem<E>::mma(dqn[2 * nd + 1], lo, bb[2], bb[3]);
        }
#pragma unroll
        for (int nd = 0; nd < DR / 16; ++nd) {
          uint32_t bb[4];
          frag_bt<SR>(bb, sKr + kk * 16 * SR + nd * 16, lane);
          Elem<E>::mma(dqr[2 * nd], hi, bb[0], bb[1]);
          Elem<E>::mma(dqr[2 * nd], lo, bb[0], bb[1]);
          Elem<E>::mma(dqr[2 * nd + 1], hi, bb[2], bb[3]);
          Elem<E>::mma(dqr[2 * nd + 1], lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + r * 8;
    if (m >= seqlen) continue;
    E* qn = DQN + ((tok + m) * H + h) * DN + 2 * t4;
    E* qr = DQR + ((tok + m) * H + h) * DR + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < DN / 8; ++nd)
      *reinterpret_cast<uint32_t*>(qn + nd * 8) = Elem<E>::pack(
          dqn[nd][2 * r] * sm_scale, dqn[nd][2 * r + 1] * sm_scale);
#pragma unroll
    for (int nd = 0; nd < DR / 8; ++nd)
      *reinterpret_cast<uint32_t*>(qr + nd * 8) = Elem<E>::pack(
          dqr[nd][2 * r] * sm_scale, dqr[nd][2 * r + 1] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// Backward: dK, dV and each head's share of dk_rope
// ---------------------------------------------------------------------------

template <int DN, int DR, int DV, int BM>
__host__ __device__ constexpr int q_stage() {
  // elements of one query tile's Qn, Qr and dO
  return BM * (DN + DR + DV + 3 * kPad);
}

template <typename E, int DN, int DR, int DV, int NW, int BM, int NS>
__global__ void __launch_bounds__(NW * kWarp, 1)
mla_bwd_dkdv_kernel(const E* __restrict__ QN, const E* __restrict__ QR,
                    const E* __restrict__ KN, const E* __restrict__ KR,
                    const E* __restrict__ V, const E* __restrict__ DO,
                    const float* __restrict__ LSE,
                    const float* __restrict__ DELTA, E* __restrict__ DKN,
                    float* __restrict__ DKR32, E* __restrict__ DVO,
                    int seqlen, int H, float qk_scale, float sm_scale) {
  constexpr int BN = 16 * NW, NT = NW * kWarp;
  constexpr int SN = DN + kPad, SR = DR + kPad, SV = DV + kPad;
  constexpr int STAGE = q_stage<DN, DR, DV, BM>();
  extern __shared__ __align__(16) unsigned char smem[];
  E* sKn = reinterpret_cast<E*>(smem);
  E* sKr = sKn + BN * SN;
  E* sV = sKr + BN * SR;
  E* sQ = sV + BN * SV;                                  // NS stages
  float* sStat = reinterpret_cast<float*>(sQ + NS * STAGE);  // [NS][2][BM]

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int start_n = blockIdx.x * BN;    // key tile 0 sees every row
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const i64 tok = (i64)b * seqlen;
  const E* qn = QN + (tok * H + h) * DN;
  const E* qr = QR + (tok * H + h) * DR;
  const E* dO = DO + (tok * H + h) * DV;
  const int tiles = (seqlen - start_n + BM - 1) / BM;

  load_rows<DN, BN, NT>(sKn, KN + (tok * H + h) * DN, (i64)H * DN, start_n,
                        seqlen);
  load_rows<DR, BN, NT>(sKr, KR + tok * DR, (i64)DR, start_n, seqlen);
  load_rows<DV, BN, NT>(sV, V + (tok * H + h) * DV, (i64)H * DV, start_n,
                        seqlen);
  auto load_q = [&](int i) {
    const int m0 = start_n + i * BM;
    E* s = sQ + (i % NS) * STAGE;
    load_rows<DN, BM, NT>(s, qn, (i64)H * DN, m0, seqlen);
    load_rows<DR, BM, NT>(s + BM * SN, qr, (i64)H * DR, m0, seqlen);
    load_rows<DV, BM, NT>(s + BM * (SN + SR), dO, (i64)H * DV, m0, seqlen);
    // a row past seqlen has lse +inf: its P, and so its dS, is 0
    float* st = sStat + (i % NS) * 2 * BM;
    for (int r = threadIdx.x; r < BM; r += NT) {
      const bool ok = m0 + r < seqlen;
      st[r] = ok ? LSE[(i64)bh * seqlen + m0 + r] : INFINITY;
      st[BM + r] = ok ? DELTA[(i64)bh * seqlen + m0 + r] : 0.f;
    }
  };
  load_q(0);
  cp_commit();
  for (int i = 1; i < NS - 1; ++i) {
    if (i < tiles) load_q(i);
    cp_commit();
  }

  const int wkey = start_n + warp * 16;    // the warp's first key
  const int key0 = wkey + g;               // this thread's: key0, key0 + 8
  float dkn[DN / 8][4], dkr[DR / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DN / 8; ++i)
    dkn[i][0] = dkn[i][1] = dkn[i][2] = dkn[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < DR / 8; ++i)
    dkr[i][0] = dkr[i][1] = dkr[i][2] = dkr[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    if (i + NS - 1 < tiles) load_q(i + NS - 1);
    cp_commit();
    cp_wait<NS - 1>();
    __syncthreads();
    const int m0 = start_n + i * BM;
    if (m0 + BM - 1 >= wkey) {
      const E* sQn = sQ + (i % NS) * STAGE;
      const E* sQr = sQn + BM * SN;
      const E* sdO = sQr + BM * SR;
      const float* sL = sStat + (i % NS) * 2 * BM;
      const float* sD = sL + BM;
      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
      float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
      for (int k = 0; k < BM / 8; ++k) {
        st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0.f;
        dpt[k][0] = dpt[k][1] = dpt[k][2] = dpt[k][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DN / 16; ++kk) {
        uint32_t ka[4];
        frag_a<SN>(ka, sKn + warp * 16 * SN, kk, lane);
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          uint32_t bb[4];
          frag_b<SN>(bb, sQn + np * 16 * SN, kk, lane);
          Elem<E>::mma(st[2 * np], ka, bb[0], bb[1]);
          Elem<E>::mma(st[2 * np + 1], ka, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DR / 16; ++kk) {
        uint32_t ka[4];
        frag_a<SR>(ka, sKr + warp * 16 * SR, kk, lane);
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          uint32_t bb[4];
          frag_b<SR>(bb, sQr + np * 16 * SR, kk, lane);
          Elem<E>::mma(st[2 * np], ka, bb[0], bb[1]);
          Elem<E>::mma(st[2 * np + 1], ka, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t va[4];
        frag_a<SV>(va, sV + warp * 16 * SV, kk, lane);
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          uint32_t bb[4];
          frag_b<SV>(bb, sdO + np * 16 * SV, kk, lane);
          Elem<E>::mma(dpt[2 * np], va, bb[0], bb[1]);
          Elem<E>::mma(dpt[2 * np + 1], va, bb[2], bb[3]);
        }
      }
      const bool masked = m0 < wkey + 15;
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);     // the query, in tile
          float p = exp2f(st[nt][e] * qk_scale - sL[c]);
          if (masked && m0 + c < key0 + (e >> 1) * 8) p = 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sD[c]);       // dS^T
        }
      // dV += P^T dO, dK += dS^T Q: k runs over the tile's queries
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t pa[4], hi[4], lo[4];
        acc_to_a<E>(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a2<E>(hi, lo, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < DV / 16; ++nd) {
          uint32_t bb[4];
          frag_bt<SV>(bb, sdO + kk * 16 * SV + nd * 16, lane);
          Elem<E>::mma(dv[2 * nd], pa, bb[0], bb[1]);
          Elem<E>::mma(dv[2 * nd + 1], pa, bb[2], bb[3]);
        }
#pragma unroll
        for (int nd = 0; nd < DN / 16; ++nd) {
          uint32_t bb[4];
          frag_bt<SN>(bb, sQn + kk * 16 * SN + nd * 16, lane);
          Elem<E>::mma(dkn[2 * nd], hi, bb[0], bb[1]);
          Elem<E>::mma(dkn[2 * nd], lo, bb[0], bb[1]);
          Elem<E>::mma(dkn[2 * nd + 1], hi, bb[2], bb[3]);
          Elem<E>::mma(dkn[2 * nd + 1], lo, bb[2], bb[3]);
        }
#pragma unroll
        for (int nd = 0; nd < DR / 16; ++nd) {
          uint32_t bb[4];
          frag_bt<SR>(bb, sQr + kk * 16 * SR + nd * 16, lane);
          Elem<E>::mma(dkr[2 * nd], hi, bb[0], bb[1]);
          Elem<E>::mma(dkr[2 * nd], lo, bb[0], bb[1]);
          Elem<E>::mma(dkr[2 * nd + 1], hi, bb[2], bb[3]);
          Elem<E>::mma(dkr[2 * nd + 1], lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = key0 + r * 8;
    if (n >= seqlen) continue;
    E* kn = DKN + ((tok + n) * H + h) * DN + 2 * t4;
    E* vv = DVO + ((tok + n) * H + h) * DV + 2 * t4;
    float* kr = DKR32 + ((tok + n) * H + h) * DR + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < DN / 8; ++nd)
      *reinterpret_cast<uint32_t*>(kn + nd * 8) = Elem<E>::pack(
          dkn[nd][2 * r] * sm_scale, dkn[nd][2 * r + 1] * sm_scale);
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd)
      *reinterpret_cast<uint32_t*>(vv + nd * 8) =
          Elem<E>::pack(dv[nd][2 * r], dv[nd][2 * r + 1]);
#pragma unroll
    for (int nd = 0; nd < DR / 8; ++nd)
      *reinterpret_cast<float2*>(kr + nd * 8) = make_float2(
          dkr[nd][2 * r] * sm_scale, dkr[nd][2 * r + 1] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename E, int DN, int DR, int DV>
cudaError_t fwd(const void* qn, const void* qr, const void* kn,
                const void* kr, const void* v, void* out, void* out32,
                void* lse, int B, int T, int H, bool save, float qk_scale,
                cudaStream_t stream) {
  constexpr int NW = kFwdWarps, BN = kFwdKeys, NS = kFwdStages, BM = 16 * NW;
  const size_t smem = sizeof(E) * (BM * (DN + DR + 2 * kPad)
                                   + NS * kv_stage<DN, DR, DV, BN>());
  const dim3 grid((T + BM - 1) / BM, B * H);
  auto kernel = mla_fwd_kernel<E, DN, DR, DV, NW, BN, NS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NW * kWarp, smem, stream>>>(
      (const E*)qn, (const E*)qr, (const E*)kn, (const E*)kr, (const E*)v,
      (E*)out, (float*)out32, (float*)lse, T, H, qk_scale, save);
  return cudaGetLastError();
}

template <typename E, int DN, int DR, int DV>
cudaError_t bwd_dq(const void* qn, const void* qr, const void* kn,
                   const void* kr, const void* v, const void* dout,
                   const void* out32, const void* lse, void* delta,
                   void* dqn, void* dqr, int B, int T, int H, float qk_scale,
                   float sm_scale, cudaStream_t stream) {
  constexpr int NW = kDqWarps, BN = kDqKeys, NS = kDqStages, BM = 16 * NW;
  const size_t smem = sizeof(E) * (BM * (DN + DR + DV + 3 * kPad)
                                   + NS * kv_stage<DN, DR, DV, BN>());
  const dim3 grid((T + BM - 1) / BM, B * H);
  auto kernel = mla_bwd_dq_kernel<E, DN, DR, DV, NW, BN, NS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NW * kWarp, smem, stream>>>(
      (const E*)qn, (const E*)qr, (const E*)kn, (const E*)kr, (const E*)v,
      (const E*)dout, (const float*)out32, (const float*)lse, (float*)delta,
      (E*)dqn, (E*)dqr, T, H, qk_scale, sm_scale);
  return cudaGetLastError();
}

template <typename E, int DN, int DR, int DV>
cudaError_t bwd_dkdv(const void* qn, const void* qr, const void* kn,
                     const void* kr, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dkn,
                     void* dkr32, void* dv, int B, int T, int H,
                     float qk_scale, float sm_scale, cudaStream_t stream) {
  constexpr int NW = kDkvWarps, BM = kDkvRows, NS = kDkvStages, BN = 16 * NW;
  const size_t smem = sizeof(E) * (BN * (DN + DR + DV + 3 * kPad)
                                   + NS * q_stage<DN, DR, DV, BM>())
                      + sizeof(float) * 2 * NS * BM;
  const dim3 grid((T + BN - 1) / BN, B * H);
  auto kernel = mla_bwd_dkdv_kernel<E, DN, DR, DV, NW, BM, NS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NW * kWarp, smem, stream>>>(
      (const E*)qn, (const E*)qr, (const E*)kn, (const E*)kr, (const E*)v,
      (const E*)dout, (const float*)lse, (const float*)delta, (E*)dkn,
      (float*)dkr32, (E*)dv, T, H, qk_scale, sm_scale);
  return cudaGetLastError();
}

// the head parts instantiated: DeepSeek-V2-Lite's
bool supported(int dn, int dr, int dv) {
  return dn == 128 && dr == 64 && dv == 128;
}

bool empty_or_bad(int B, int T, int H, int dn, int dr, int dv,
                  cudaError_t* err) {
  if (!supported(dn, dr, dv) || B < 0 || T < 0 || H < 0
      || (i64)B * H > 65535) {
    *err = cudaErrorInvalidValue;
    return true;
  }
  *err = cudaSuccess;
  return B == 0 || T == 0 || H == 0;
}

}  // namespace

// fp16: 1 for float16 operands, 0 for bfloat16; save: write out32 and lse
extern "C" int mla_fwd_launch(const void* qn, const void* qr, const void* kn,
                              const void* kr, const void* v, void* out,
                              void* out32, void* lse, int B, int T, int H,
                              int dn, int dr, int dv, int fp16, int save,
                              float qk_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (empty_or_bad(B, T, H, dn, dr, dv, &err)) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = fp16 ? fwd<__half, 128, 64, 128>(qn, qr, kn, kr, v, out, out32, lse,
                                         B, T, H, save, qk_scale, st)
             : fwd<__nv_bfloat16, 128, 64, 128>(qn, qr, kn, kr, v, out,
                                                out32, lse, B, T, H, save,
                                                qk_scale, st);
  return (int)err;
}

extern "C" int mla_bwd_dq_launch(const void* qn, const void* qr,
                                 const void* kn, const void* kr,
                                 const void* v, const void* dout,
                                 const void* out32, const void* lse,
                                 void* delta, void* dqn, void* dqr, int B,
                                 int T, int H, int dn, int dr, int dv,
                                 int fp16, float qk_scale, float sm_scale,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (empty_or_bad(B, T, H, dn, dr, dv, &err)) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = fp16 ? bwd_dq<__half, 128, 64, 128>(qn, qr, kn, kr, v, dout, out32,
                                            lse, delta, dqn, dqr, B, T, H,
                                            qk_scale, sm_scale, st)
             : bwd_dq<__nv_bfloat16, 128, 64, 128>(
                   qn, qr, kn, kr, v, dout, out32, lse, delta, dqn, dqr, B,
                   T, H, qk_scale, sm_scale, st);
  return (int)err;
}

extern "C" int mla_bwd_dkdv_launch(const void* qn, const void* qr,
                                   const void* kn, const void* kr,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dkn, void* dkr32, void* dv, int B,
                                   int T, int H, int dn, int dr, int dvw,
                                   int fp16, float qk_scale, float sm_scale,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (empty_or_bad(B, T, H, dn, dr, dvw, &err)) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = fp16 ? bwd_dkdv<__half, 128, 64, 128>(qn, qr, kn, kr, v, dout, lse,
                                              delta, dkn, dkr32, dv, B, T, H,
                                              qk_scale, sm_scale, st)
             : bwd_dkdv<__nv_bfloat16, 128, 64, 128>(
                   qn, qr, kn, kr, v, dout, lse, delta, dkn, dkr32, dv, B, T,
                   H, qk_scale, sm_scale, st);
  return (int)err;
}

extern "C" const char* mla_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
