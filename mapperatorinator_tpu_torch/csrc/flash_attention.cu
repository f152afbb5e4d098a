// Flash attention in fp32 for Hopper (sm_90a): the forward (kernel B) and
// the backward (kernel C), every product on the tensor cores as three TF32
// products (split-TF32), so fp32 inputs keep fp32-grade accuracy.
//
// Replaces the Pallas kernels of mapperatorinator_tpu/ops/attention_kernel.py:
// _attention_kernel, launched by _flash_forward (:88) behind flash_attention,
// and _attention_bwd_kernel, launched by _bwd_call (:197) via _flash_backward.
// ops/attention_kernel.py (attention_route) sends every fp32 call here; bf16
// with D 64 goes to flash_attention_sm90.cu.
//
// What it computes. Forward: out = softmax(q k^T * scale, masked) v and the
// row log-sum-exp. Backward, from q, k, v, O, its lse and dO:
//   P = exp(q k^T * scale - lse) (recomputed, masked as in the forward),
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO * O),
//   dQ = dS K * scale, dK = dS^T Q * scale.
// Masks come from indices: causal (k <= q), the band |q - k| <= window / 2,
// and a (B, S) key mask. A masked logit is finfo(float32).min and a column
// past S is -inf, exactly as in the reference: a row whose keys are all
// masked averages v over all S keys, its lse rounds to finfo.min, and the
// backward gives it P = 1/S on every key and dq = dk = 0 exactly (the exact
// gradient of jnp.where(mask, logits, finfo.min); the Pallas backward
// differs there). Softmax, row max and sum, lse and delta stay in fp32, with
// the accurate expf.
//
// What bounds it on an H100: per (batch, head) the forward does 2 products
// of T x S x D (4 T S D flops) and the backward 5 (10 T S D) against a few
// MB of q, k, v, O, dO: bound by operations. fp32 FMAs peak at 67 TFLOP/s;
// one TF32 tensor-core product is far faster (495 TFLOP/s dense) but keeps 10
// mantissa bits (a relative error of 2^-11 an operand), far from the fp32
// bar of 2e-5. So every fp32 operand x is split, as its fragment is read
// from shared memory or taken from registers, into hi = tf32(x) and lo =
// tf32(x - hi) (round to nearest, ties away from zero: cvt.rna.tf32.f32,
// written as integer ops so the low 13 bits are exactly 0), and a.b is
// taken as the big products hi.hi' plus the small ones hi.lo' + lo.hi':
// three TF32 products, about 165 TFLOP/s of fp32-grade products at the
// published rate. The rounding-faithful plain versions are
// attention_plain_fp32_tc and attention_backward_plain_fp32_tc.
//
// Design. The products are mma.sync.m16n8k8 tf32 (warp-wide, fragments in
// registers). Tiles arrive in shared memory by cp.async (16 bytes a thread,
// zero-filled past T, S or the head dim) through a two-stage ring, so the
// next tile is in flight while the tensor cores work on the current one.
// q, k, v and dO are read in their (B, T, H, D) layout through strides
// (fused qkv views included; the wrapper checks 16-byte alignment). Rows
// are padded to KD + 4 floats (KD: the head dim rounded up to 32, 64 or
// 128), so every fragment read is free of bank conflicts. A product whose
// A operand is an accumulator (P V, P^T dO, dS^T Q) permutes its contraction
// index inside each step of 8 (logical k -> 2k, k + 4 -> 2k + 1): the
// accumulator's (row, column pair) then is the A fragment, no shuffle is
// needed, and the B fragment reads rows 2t and 2t + 1 of the tile. Per tile
// the causal and band masks class the (query, key) block as all live, none
// live or mixed, and a vote at the tile's barrier says whether all its keys
// are live: only a mixed tile tests each element. The tensor cores' own
// sums truncate (round toward zero): kept in their accumulators along a
// whole contraction, that bias grows with its length. So each step of 8
// along a contraction sums its big and its small products in two fresh
// accumulators, which are added to the running sums in fp32, rounded to
// nearest (mma_3xtf32).
//
// Forward: one block per (batch * head, BM queries), each warp owning 16
// query rows end to end, its Q fragments split once into registers (up to
// D 64): S = Q K^T over a 64-key tile, masks, an online softmax in
// registers, O = alpha O + P V. Four warps, 64 queries, a block.
//
// Backward: one block of four warps per (batch * head, 64 keys), each warp
// owning 16 key rows and keeping their dK and dV in fp32 registers across
// every 32-query tile: S^T = K Q^T and dP^T = V dO^T, P and dS in fp32,
// dV += P^T dO and dK += dS^T Q; dS^T goes to shared memory, and after a
// block barrier dQ = dS K for the tile's queries over the block's 64 keys
// is added into a zeroed fp32 (B, T, H, D) buffer with 8-byte vector
// atomics (one partial per key block, so the order of the sums changes from
// run to run). A small kernel first computes delta.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float ALL_MASKED = -1e38f;               // an lse below this: the row has no live key
constexpr int BWD_THREADS = 128;                   // four warps
constexpr int BWD_N = 64;                          // keys a backward block, 16 a warp
constexpr int BWD_M = 32;                          // queries a backward step

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tf32(x), round to nearest with ties away from zero, low 13 bits zero
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, tf32 operands, fp32 accumulators. Fragments (g = lane
// / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0 (g, 2t), d1 (g, 2t + 1),
// d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, from zero accumulators
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Split fragments: hi and lo of the A (16 x 8) and B (8 x 8) operands of one
// k step.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a b as three TF32 products of the split operands: the big product
// hi.hi' and the small ones hi.lo' + lo.hi' each summed in fresh
// accumulators, which are then added to d in fp32. The tensor cores' own
// sums truncate: a sum kept in their accumulators would gather a bias with
// every step along the contraction.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const FragB& b) {
  float big[4], small[4];
  mma_tf32_first(small, a.hi, b.lo);
  mma_tf32(small, a.lo, b.hi);
  mma_tf32_first(big, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += big[i] + small[i];
}

// Fragment reads from a row-major tile with LD floats a row, split on the way.
// A over rows r0.. and columns c0..c0 + 7
template <int LD>
__device__ __forceinline__ void frag_a(const float* s, int r0, int c0, int g, int t, FragA& f) {
  split(s[(r0 + g) * LD + c0 + t], f.hi[0], f.lo[0]);
  split(s[(r0 + g + 8) * LD + c0 + t], f.hi[1], f.lo[1]);
  split(s[(r0 + g) * LD + c0 + t + 4], f.hi[2], f.lo[2]);
  split(s[(r0 + g + 8) * LD + c0 + t + 4], f.hi[3], f.lo[3]);
}

// A whose rows are the tile's columns (the tile holds A transposed), over the
// tile's rows k0.. in the permuted order: the A of dQ = dS K from dS^T
template <int LD>
__device__ __forceinline__ void frag_a_t(const float* s, int k0, int m0, int g, int t, FragA& f) {
  split(s[(k0 + 2 * t) * LD + m0 + g], f.hi[0], f.lo[0]);
  split(s[(k0 + 2 * t) * LD + m0 + g + 8], f.hi[1], f.lo[1]);
  split(s[(k0 + 2 * t + 1) * LD + m0 + g], f.hi[2], f.lo[2]);
  split(s[(k0 + 2 * t + 1) * LD + m0 + g + 8], f.hi[3], f.lo[3]);
}

// B with n over the tile's rows n0.. and k over its columns k0.. (S = Q K^T)
template <int LD>
__device__ __forceinline__ void frag_b_nk(const float* s, int n0, int k0, int g, int t, FragB& f) {
  split(s[(n0 + g) * LD + k0 + t], f.hi[0], f.lo[0]);
  split(s[(n0 + g) * LD + k0 + t + 4], f.hi[1], f.lo[1]);
}

// B with k over the tile's rows k0.. (permuted) and n over its columns n0..
// (O += P V)
template <int LD>
__device__ __forceinline__ void frag_b_kn(const float* s, int k0, int n0, int g, int t, FragB& f) {
  split(s[(k0 + 2 * t) * LD + n0 + g], f.hi[0], f.lo[0]);
  split(s[(k0 + 2 * t + 1) * LD + n0 + g], f.hi[1], f.lo[1]);
}

// an accumulator of 16 x 8 as the A fragment of the next product's k step
// (permuted contraction index)
__device__ __forceinline__ void frag_from_acc(const float (&c)[4], FragA& f) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// rows [r0, r0 + ROWS) of one (batch, head) of a (B, T, H, D) operand into a
// tile of KD + 4 floats a row; rows at or past n and columns at or past D are 0
template <int ROWS, int KD, int NTHR>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride, int r0, int n, int D,
                                          int tid) {
  constexpr int CH = KD / 4;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NTHR) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < n && c * 4 < D;
    cp_async16(dst + r * (KD + 4) + c * 4, src + (ok ? (r0 + r) * stride + c * 4 : 0), ok);
  }
}

// the live flags of keys [k0, k0 + N): 0 past S or masked. Each thread reads
// back only the flags it wrote itself before the tile's barrier.
template <int N, int NTHR>
__device__ __forceinline__ void load_flags(int* dst, const int* key_ok, int k0, int S, int tid) {
  for (int i = tid; i < N; i += NTHR) {
    const int key = k0 + i;
    if (key_ok != nullptr)
      cp_async4(dst + i, key_ok + (key < S ? key : 0), key < S);
    else
      dst[i] = key < S;
  }
}

template <int N, int NTHR>
__device__ __forceinline__ bool own_flags_live(const int* flags, int tid) {
  bool live = true;
  for (int i = tid; i < N; i += NTHR) live = live && flags[i] != 0;
  return live;
}

// How the causal and band masks treat a block of (query, key) pairs, decided
// from its corners: every pair passes them, none does, or some need a test.
enum TileClass { SOME_LIVE, ALL_LIVE, NONE_LIVE };

__device__ __forceinline__ TileClass tile_class(int t_lo, int t_hi, int s_lo, int s_hi, int causal, int window) {
  const int hw = window / 2;
  if ((causal && s_lo > t_hi) || (window && (s_lo - t_hi > hw || t_lo - s_hi > hw))) return NONE_LIVE;
  if ((!causal || s_hi <= t_lo) && (!window || (t_hi - s_lo <= hw && s_hi - t_lo <= hw))) return ALL_LIVE;
  return SOME_LIVE;
}

__device__ __forceinline__ bool pair_live(int t, int key, int causal, int window) {
  return (!causal || key <= t) && (!window || abs(t - key) <= window / 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* key_ok;  // (B, S) 0/1 flags, or null
  float* out;         // (B, T, H, D) contiguous
  float* lse;         // (B, H, T) row log-sum-exp, or null
  int B, T, S, H, D;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long m_sb;
  int causal, window;
  float scale;
};

constexpr int FWD_WARPS = 4;  // 16 query rows each
constexpr int FWD_M = 16 * FWD_WARPS;
constexpr int FWD_N = 64;  // keys a tile

template <int KD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (FWD_M * (KD + 4) + 4 * FWD_N * (KD + 4)) + sizeof(int) * 2 * FWD_N;
}

template <int KD>
__global__ void __launch_bounds__(FWD_WARPS * 32) flash_fwd_kernel(const Params p) {
  constexpr int BM = FWD_M, BN = FWD_N;
  constexpr int NTHR = FWD_WARPS * 32;
  constexpr int LD = KD + 4;
  constexpr int NT = BN / 8;  // key column groups of a logits tile
  constexpr int DT = KD / 8;  // head-dim groups
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                                   // BM x LD
  float* sK = sQ + BM * LD;                           // stage s at sK + s * BN * LD
  float* sV = sK + 2 * BN * LD;                       // likewise
  int* sOk = reinterpret_cast<int*>(sV + 2 * BN * LD);  // [2][BN] key flags

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const int* key_ok = p.key_ok ? p.key_ok + b * p.m_sb : nullptr;
  const int n_tiles = (p.S + BN - 1) / BN;

  auto load_kv = [&](int j) {
    const int st = j & 1;
    load_rows<BN, KD, NTHR>(sK + st * BN * LD, k, p.k_ss, j * BN, p.S, p.D, tid);
    load_rows<BN, KD, NTHR>(sV + st * BN * LD, v, p.v_ss, j * BN, p.S, p.D, tid);
    load_flags<BN, NTHR>(sOk + st * BN, key_ok, j * BN, p.S, tid);
  };

  load_rows<BM, KD, NTHR>(sQ, q, p.q_st, q0, p.T, p.D, tid);
  cp_async_commit();
  load_kv(0);
  cp_async_commit();

  const int wr = warp * 16;  // this warp's first query row in the tile
  const int t_row[2] = {q0 + wr + g, q0 + wr + g + 8};

  // up to D 64 the warp's Q fragments stay in registers, split once
  constexpr bool Q_IN_REGS = KD <= 64;
  FragA qf[Q_IN_REGS ? DT : 1];
  if constexpr (Q_IN_REGS) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) frag_a<LD>(sQ, wr, 8 * kk, g, t4, qf[kk]);
  }

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int st = j & 1, k0 = j * BN;
    const int* ok = sOk + st * BN;
    const bool keys_live = __syncthreads_and(own_flags_live<BN, NTHR>(ok, tid));
    const float* kt = sK + st * BN * LD;
    const float* vt = sV + st * BN * LD;

    // S = Q K^T for this warp's 16 rows
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      FragA a;
      if constexpr (Q_IN_REGS)
        a = qf[kk];
      else
        frag_a<LD>(sQ, wr, 8 * kk, g, t4, a);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        FragB f;
        frag_b_nk<LD>(kt, 8 * n, 8 * kk, g, t4, f);
        mma_3xtf32(s[n], a, f);
      }
    }

    // masks and the online softmax, fp32
    float mx[2] = {m[0], m[1]};
    const TileClass cls = tile_class(q0 + wr, q0 + wr + 15, k0, k0 + BN - 1, p.causal, p.window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, key = k0 + 8 * n + 2 * t4 + (i & 1);
        float x;
        if (cls == ALL_LIVE && keys_live) {
          x = s[n][i] * p.scale;
        } else if (key >= p.S) {
          x = -INFINITY;  // a column past S takes no part
        } else {
          const bool live = cls != NONE_LIVE && ok[key - k0] != 0 && pair_live(t_row[r], key, p.causal, p.window);
          x = live ? s[n][i] * p.scale : MASKED;
        }
        s[n][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);  // m = -inf before the first tile: 0
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        l[i >> 1] += s[n][i];
      }
    }
    // O = alpha O + P V over the tile's keys
#pragma unroll
    for (int n = 0; n < DT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      FragA a;
      frag_from_acc(s[kk], a);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        FragB f;
        frag_b_kn<LD>(vt, 8 * kk, 8 * n, g, t4, f);
        mma_3xtf32(o[n], a, f);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t_row[r];
    const float sum = quad_sum(l[r]);
    if (t >= p.T) continue;
    const float inv = 1.f / sum;
    // a row whose keys are all masked has m = finfo.min and l = S, so its
    // lse rounds to finfo.min: the backward reads that as "no live key"
    if (p.lse != nullptr && t4 == 0) p.lse[(static_cast<long long>(b) * p.H + h) * p.T + t] = m[r] + logf(sum);
    float* row = p.out + ((static_cast<long long>(b) * p.T + t) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      if (8 * n < p.D)
        *reinterpret_cast<float2*>(row + 8 * n + 2 * t4) = make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <int KD>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<KD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + FWD_M - 1) / FWD_M, p.B * p.H);
  flash_fwd_kernel<KD><<<grid, FWD_WARPS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// Backward.

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const int* key_ok;  // (B, S) 0/1 flags, or null
  const float* out;   // O, (B, T, H, D) contiguous
  const float* dout;  // dO, (B, T, H, D) strided
  const float* lse;   // (B, H, T)
  float* delta;       // (B, H, T), written by flash_bwd_delta_kernel
  float* dq;          // (B, T, H, D) contiguous, zeroed, added to
  float* dk;          // (B, S, H, D) contiguous
  float* dv;          // (B, S, H, D) contiguous
  int B, T, S, H, D;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_st, g_sh;
  long long m_sb;
  int causal, window;
  float scale;
};

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one warp per row
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const BwdParams p) {
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.T * p.H) return;
  const int h = static_cast<int>(row % p.H);
  const int t = static_cast<int>((row / p.H) % p.T);
  const int b = static_cast<int>(row / (static_cast<long long>(p.H) * p.T));
  const float* o = p.out + row * p.D;
  const float* g = p.dout + b * p.g_sb + t * p.g_st + h * p.g_sh;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(o[d], g[d], acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.T + t] = acc;
}

template <int KD>
constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * BWD_N * (KD + 4) + 4 * BWD_M * (KD + 4) + BWD_N * (BWD_M + 4) + 4 * BWD_M) +
         sizeof(int) * BWD_N;
}

template <int KD>
__global__ void __launch_bounds__(BWD_THREADS) flash_bwd_kernel(const BwdParams p) {
  constexpr int BM = BWD_M;
  constexpr int LD = KD + 4;
  constexpr int LDT = BM + 4;    // dS^T rows
  constexpr int NT = BM / 8;     // query column groups of S^T and dP^T
  constexpr int DT = KD / 8;     // head-dim groups
  constexpr int RG = BM / 16;    // dQ: row groups of 16 queries
  constexpr int DQT = DT * RG / 4;  // dQ: head-dim groups a warp
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                 // BWD_N x LD
  float* sV = sK + BWD_N * LD;      // BWD_N x LD
  float* sQ = sV + BWD_N * LD;      // stage s at sQ + s * BM * LD
  float* sG = sQ + 2 * BM * LD;     // dO, likewise
  float* sDS = sG + 2 * BM * LD;    // dS^T, BWD_N x LDT
  float* sL = sDS + BWD_N * LDT;    // lse, [2][BM]
  float* sDelta = sL + 2 * BM;      // delta, [2][BM]
  int* sOk = reinterpret_cast<int*>(sDelta + 2 * BM);  // key flags, BWD_N

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BWD_N;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* gr = p.dout + b * p.g_sb + h * p.g_sh;
  const int* key_ok = p.key_ok ? p.key_ok + b * p.m_sb : nullptr;
  const float* lse = p.lse + static_cast<long long>(blockIdx.y) * p.T;
  const float* delta = p.delta + static_cast<long long>(blockIdx.y) * p.T;
  const float uniform = 1.f / p.S;  // P of every key in a row whose keys are all masked
  const int n_tiles = (p.T + BM - 1) / BM;

  auto load_q = [&](int it) {
    const int st = it & 1, t0 = it * BM;
    load_rows<BM, KD, BWD_THREADS>(sQ + st * BM * LD, q, p.q_st, t0, p.T, p.D, tid);
    load_rows<BM, KD, BWD_THREADS>(sG + st * BM * LD, gr, p.g_st, t0, p.T, p.D, tid);
    for (int i = tid; i < BM; i += BWD_THREADS) {  // past T: lse = delta = 0, with zero q and dO rows
      const bool in = t0 + i < p.T;
      cp_async4(sL + st * BM + i, lse + (in ? t0 + i : 0), in);
      cp_async4(sDelta + st * BM + i, delta + (in ? t0 + i : 0), in);
    }
  };

  load_rows<BWD_N, KD, BWD_THREADS>(sK, k, p.k_ss, k0, p.S, p.D, tid);
  load_rows<BWD_N, KD, BWD_THREADS>(sV, v, p.v_ss, k0, p.S, p.D, tid);
  load_flags<BWD_N, BWD_THREADS>(sOk, key_ok, k0, p.S, tid);
  load_q(0);
  cp_async_commit();

  const int kr = warp * 16;  // this warp's first key row in the block
  const int s_row[2] = {k0 + kr + g, k0 + kr + g + 8};
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_q(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int st = it & 1, t0 = it * BM;
    const bool keys_live = __syncthreads_and(own_flags_live<BWD_N, BWD_THREADS>(sOk, tid));
    const float* qt = sQ + st * BM * LD;
    const float* gt = sG + st * BM * LD;
    const float* lt = sL + st * BM;
    const float* dt = sDelta + st * BM;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      FragA ka, va;
      frag_a<LD>(sK, kr, 8 * kk, g, t4, ka);
      frag_a<LD>(sV, kr, 8 * kk, g, t4, va);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        FragB f;
        frag_b_nk<LD>(qt, 8 * n, 8 * kk, g, t4, f);
        mma_3xtf32(s[n], ka, f);
        frag_b_nk<LD>(gt, 8 * n, 8 * kk, g, t4, f);
        mma_3xtf32(dp[n], va, f);
      }
    }

    // P^T into s, dS^T into dp, fp32; element i of group n: key row
    // kr + g + 8 (i / 2), query column 8 n + 2 t + i % 2
    const TileClass cls = tile_class(t0, t0 + BM - 1, k0 + kr, k0 + kr + 15, p.causal, p.window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * t4 + (i & 1);
        const float L = lt[c];
        if (cls == ALL_LIVE && keys_live) {  // past T: q, dO, lse and delta are 0, so P dO = dS = 0
          s[n][i] = expf(s[n][i] * p.scale - L);
          dp[n][i] = s[n][i] * (dp[n][i] - dt[c]);
        } else {
          const int key = s_row[i >> 1];
          const bool live = cls != NONE_LIVE && sOk[kr + g + 8 * (i >> 1)] != 0 &&
                            pair_live(t0 + c, key, p.causal, p.window);
          // masked in-range entries: P is 0, or 1/S in a row with no live key
          const float pr = live ? expf(s[n][i] * p.scale - L) : (L < ALL_MASKED && key < p.S ? uniform : 0.f);
          dp[n][i] = live ? pr * (dp[n][i] - dt[c]) : 0.f;
          s[n][i] = pr;
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      FragA pa, da;
      frag_from_acc(s[kk], pa);
      frag_from_acc(dp[kk], da);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        FragB f;
        frag_b_kn<LD>(gt, 8 * kk, 8 * n, g, t4, f);
        mma_3xtf32(dv[n], pa, f);
        frag_b_kn<LD>(qt, 8 * kk, 8 * n, g, t4, f);
        mma_3xtf32(dk[n], da, f);
      }
    }

    // dS^T to shared memory for dQ
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(sDS + (kr + g + 8 * r) * LDT + 8 * n + 2 * t4) =
            make_float2(dp[n][2 * r], dp[n][2 * r + 1]);
    }
    __syncthreads();

    // dQ = dS K: this warp's 16 queries (row group warp % RG) and DQT head-dim
    // groups (from group (warp / RG) * DQT), over the block's 64 keys
    const int qr = (warp % RG) * 16, dc = (warp / RG) * DQT;
    float dq[DQT][4];
#pragma unroll
    for (int n = 0; n < DQT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BWD_N / 8; ++kk) {
      FragA a;
      frag_a_t<LDT>(sDS, 8 * kk, qr, g, t4, a);
#pragma unroll
      for (int n = 0; n < DQT; ++n) {
        FragB f;
        frag_b_kn<LD>(sK, 8 * kk, 8 * (dc + n), g, t4, f);
        mma_3xtf32(dq[n], a, f);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + qr + g + 8 * r;
      if (t >= p.T) continue;
      float* row = p.dq + ((static_cast<long long>(b) * p.T + t) * p.H + h) * p.D;
#pragma unroll
      for (int n = 0; n < DQT; ++n) {
        const int d = 8 * (dc + n) + 2 * t4;
        if (d < p.D)
          atomicAdd(reinterpret_cast<float2*>(row + d),
                    make_float2(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale));
      }
    }
    __syncthreads();  // dS^T and stage st are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s_row[r];
    if (s >= p.S) continue;
    const long long base = ((static_cast<long long>(b) * p.S + s) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d < p.D) {
        *reinterpret_cast<float2*>(p.dk + base + d) = make_float2(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<float2*>(p.dv + base + d) = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

template <int KD>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.T * p.H;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = bwd_smem<KD>();
  err = cudaFuncSetAttribute(flash_bwd_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BWD_N - 1) / BWD_N, p.B * p.H);
  flash_bwd_kernel<KD><<<grid, BWD_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}


}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* key_ok, void* out,
                                   void* lse, int B, int T, int S, int H, int D, long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, long long m_sb, int causal, int window,
                                   float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<const int*>(key_ok), static_cast<float*>(out), static_cast<float*>(lse),
                 B, T, S, H, D, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_fwd<32>(p, s);
  if (D <= 64) return (int)launch_fwd<64>(p, s);
  return (int)launch_fwd<128>(p, s);
}

// dq must be zeroed by the caller; delta is scratch of B * H * T floats.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* key_ok, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int B, int T, int S, int H, int D, long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                   long long v_sh, long long g_sb, long long g_st, long long g_sh, long long m_sb,
                                   int causal, int window, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const BwdParams p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                    static_cast<const int*>(key_ok), static_cast<const float*>(out), static_cast<const float*>(dout),
                    static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(dq),
                    static_cast<float*>(dk), static_cast<float*>(dv),
                    B, T, S, H, D, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_st, g_sh, m_sb,
                    causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_bwd<32>(p, s);
  if (D <= 64) return (int)launch_bwd<64>(p, s);
  return (int)launch_bwd<128>(p, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
