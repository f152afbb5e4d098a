// Flash attention for Hopper's tensor cores (sm_90a), bf16 operands with
// fp32 accumulation: the forward (kernel B) and the backward (kernel C) for a
// head dim of 64.
//
// Replaces the Pallas kernels of mapperatorinator_tpu/ops/attention_kernel.py:
// _attention_kernel, launched by _flash_forward (:88), and
// _attention_bwd_kernel, launched by _bwd_call (:197). fp32 takes the
// kernels of flash_attention.cu, which hold it to 2e-5 with three TF32
// products for each fp32 one. ops/attention_kernel.py picks the route: bf16
// with D = 64 comes here.
//
// What it computes is what flash_attention.cu computes, with the rounding
// points of the model's own bf16 attention (transformer.py _attend): logits,
// softmax and every sum in fp32, P (and in the backward dS) rounded to bf16
// before the products that take them. Masks come from indices: causal, the
// band |q - k| <= window / 2 and a (B, S) key mask; a masked logit is
// finfo(f32).min and a column past S is -inf, so a row whose keys are all
// masked averages v over all S keys and its lse rounds to finfo.min. The
// backward gives such a row P = 1/S on every key, dv terms on every key and
// exactly zero dq and dk (the exact gradient; the Pallas backward differs
// there). No tile is skipped for the causal or band masks: that would
// change the all-masked-row semantics. So under the causal mask about half
// of the products are computed only to be masked: wasted work, not
// throughput.
//
// What bounds it: per (batch, head) the forward does 2 products of T x S x D
// (4 T S D flops) and the backward 5 (10 T S D) against a few MB of q, k, v,
// O, dO: at T = S = 1024 that is hundreds of flops per byte, far above the
// H100's ~295 bf16 flops per byte of HBM, so both are bound by operations at
// 989 TFLOP/s (bf16 dense). The design feeds the tensor cores:
//
// - Every product is a warpgroup MMA (wgmma.mma_async, m64nNk16, fp32
//   accumulators in registers). One warpgroup (128 threads) owns 64 rows of
//   a product.
// - Every tile in shared memory has one format: rows of D = 64 bf16 = 128
//   bytes, the 16-byte chunks of row r stored at chunk ^ (r % 8) (the
//   128-byte swizzle), tiles 1024-byte aligned. The same tile is read as a
//   K-major operand (contracting over D: S = Q K^T) or an MN-major one
//   (contracting over rows: O += P V, dV += P^T dO), only the descriptor
//   differs, so nothing is transposed in memory.
// - Tiles arrive by cp.async (16 bytes a thread, zero-filled past T or S,
//   so the ragged edge needs no separate path) into a two-stage ring: the
//   next K/V tile (forward) or Q/dO tile (backward) is in flight while the
//   tensor cores work on the current one. q, k, v and dO are read in their
//   (B, T, H, D) layout through strides, fused qkv/kv views included; the
//   wrapper checks the 16-byte alignment this needs.
// - P and dS go from the fp32 accumulator to bf16 registers and feed the
//   next product as the register A operand (RS wgmma): the accumulator's
//   (row, column pair) layout is the A fragment's, so no shuffle is needed.
//
// Forward: one block of one warpgroup per (batch * head, 64 queries),
// streaming 64-key tiles: S = Q K^T (SS, m64n64), the masks, an online
// softmax in fp32 registers (running max and sum per row), then O += P V
// (RS, m64n64, V MN-major). It writes O and the row lse that the backward
// reads. Tiles: a block needs ~42 KB of shared memory and ~125 registers a
// thread, so several blocks share an SM and one block's softmax (the
// exponentials run on the special-function unit, about as long as the
// products at this head dim) overlaps another's products. Masks cost per
// element only where a tile needs them: a tile whose pairs all pass the
// causal and band tests and whose keys are all live (one vote at the tile's
// barrier) scales the logits alone, and one that no pair passes is filled.
//
// Backward: one block of two warpgroups per (batch * head, 128 keys); each
// warpgroup owns 64 key rows and keeps their dK and dV in fp32 registers
// across every 64-query tile: S^T = K Q^T and dP^T = V dO^T (SS, m64n64), P
// and dS in fp32, dV += P^T dO and dK += dS^T Q (RS, m64n64). dS^T goes to
// shared memory as bf16, and after a block barrier dQ = dS (K - k_mean) (SS,
// m64n32, both operands MN-major) is computed by both warpgroups, each for
// 32 of the 64 head dims over all 128 keys, and summed into an fp32 (B, T,
// H, D) buffer with 16-byte vector atomics (atomicAdd on float4, after a
// lane-pair exchange): one partial per key tile, so the order of the sums
// changes from run to run. k_mean is the mean of the (batch, head)'s live
// keys: the keys are centred on it for dQ because a row of the kernel's dS
// does not sum to exactly 0 (delta = rowsum(dO O) comes from the bf16 O),
// and that error would otherwise reach dQ multiplied by the keys' common
// component (flash_bwd_rows_sm90). A small kernel first writes delta and
// sums the live keys. Tiles: 64 queries keep the five accumulators (S, dP,
// dK, dV, dQ: 32 + 32 + 32 + 32 + 16 a thread) in registers; 128 keys a
// block halve the dQ atomics of 64.
//
// Later work: warp specialisation (a producer warp with TMA, the softmax of
// one tile overlapping the next tile's products), skipping masked tiles
// while keeping the all-masked-row semantics, D 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HEAD_DIM = 64;
constexpr int ROW_BYTES = HEAD_DIM * 2;  // one swizzle row per token
constexpr int WG_THREADS = 128;          // one warpgroup
constexpr int FWD_M = 64;                // queries per forward block (one warpgroup)
constexpr int FWD_N = 64;                // keys per forward tile
constexpr int BWD_THREADS = 256;         // two warpgroups
constexpr int BWD_N = 128;               // keys per backward block, 64 per warpgroup
constexpr int BWD_M = 64;                // queries per backward tile
constexpr int DQ_N = 32;                 // head dims of dQ per warpgroup
constexpr float MASKED = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float ALL_MASKED = -1e38f;  // an lse below this: the row has no live key
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swizzled(int r, int c) { return r * ROW_BYTES + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory (cp.async, st.shared) become visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// rows [r0, r0 + ROWS) of one (batch, head) of a (B, T, H, 64) operand into a
// swizzled tile; rows at or past n are zero
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base, long long stride, int r0, int n, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 3, c = idx & 7;
    const int g = r0 + r;
    const bool ok = g < n;
    cp_async16(dst + swizzled(r, c), base + (ok ? g : 0) * stride + c * 8, ok);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading offset 16 B (unused: no operand spans two swizzle atoms along its
// contiguous dimension), 1024 B between groups of 8 rows, swizzle mode 128 B
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// a descriptor moved by a byte offset (16-byte units in the address field)
__device__ __forceinline__ uint64_t advance(uint64_t d, uint32_t bytes) { return d + (bytes >> 4); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// How the causal and band masks treat a block of (query, key) pairs, decided
// once per tile from its corners: every pair passes them, none does, or some
// pairs need their own test. The key mask and the ragged edge are separate.
enum TileClass { SOME_LIVE, ALL_LIVE, NONE_LIVE };

__device__ __forceinline__ TileClass tile_class(int t_lo, int t_hi, int s_lo, int s_hi, int causal, int window) {
  const int hw = window / 2;
  if ((causal && s_lo > t_hi) || (window && (s_lo - t_hi > hw || t_lo - s_hi > hw))) return NONE_LIVE;
  if ((!causal || s_hi <= t_lo) && (!window || (t_hi - s_lo <= hw && s_hi - t_lo <= hw))) return ALL_LIVE;
  return SOME_LIVE;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// m64nNk16 products, bf16 x bf16 -> fp32. _ss: A and B from shared memory
// (TA / TB = 1: MN-major); _rs: A from registers, four bf16x2 per thread.
// Accumulator element i of a thread (lane l of warp w in the warpgroup) is
// row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* key_ok;  // (B, S) 0/1 flags, or null
  bf16* out;          // (B, T, H, 64) contiguous
  float* lse;         // (B, H, T), or null
  int B, T, S, H;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long m_sb;
  int causal, window;
  float scale;
};

constexpr int FWD_Q_BYTES = FWD_M * ROW_BYTES;   // 8 KB
constexpr int FWD_KV_BYTES = FWD_N * ROW_BYTES;  // 8 KB a stage of k or v
constexpr int FWD_SMEM = FWD_Q_BYTES + 4 * FWD_KV_BYTES + 2 * FWD_N * 4 + 1024;  // + alignment slack

__global__ void __launch_bounds__(WG_THREADS, 2) flash_fwd_sm90_kernel(const FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + FWD_Q_BYTES;        // stage s at sK + s * FWD_KV_BYTES
  const uint32_t sV = sK + 2 * FWD_KV_BYTES;   // likewise
  const uint32_t sOk = sV + 2 * FWD_KV_BYTES;  // key flags, [2][FWD_N] int
  int* ok_flags = reinterpret_cast<int*>(smem_raw + (sOk - raw));  // 1: the key is in range and unmasked

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FWD_M;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;
  const int* key_ok = p.key_ok ? p.key_ok + b * p.m_sb : nullptr;
  const int n_tiles = (p.S + FWD_N - 1) / FWD_N;

  auto load_kv = [&](int j) {
    const int st = j & 1, k0 = j * FWD_N;
    load_tile<FWD_N, WG_THREADS>(sK + st * FWD_KV_BYTES, k, p.k_ss, k0, p.S, tid);
    load_tile<FWD_N, WG_THREADS>(sV + st * FWD_KV_BYTES, v, p.v_ss, k0, p.S, tid);
    if (tid < FWD_N) {
      const int key = k0 + tid;
      if (key_ok != nullptr)
        cp_async4(sOk + (st * FWD_N + tid) * 4, key_ok + (key < p.S ? key : 0), key < p.S);
      else
        ok_flags[st * FWD_N + tid] = key < p.S;
    }
  };

  load_tile<FWD_M, WG_THREADS>(sQ, q, p.q_st, q0, p.T, tid);
  load_kv(0);
  cp_async_commit();

  // this thread's two query rows and its first column in each 8-column group
  const int row = warp * 16 + (lane >> 2);
  const int t_row[2] = {q0 + row, q0 + row + 8};
  const int col0 = 2 * (lane & 3);
  const int half_window = p.window / 2;
  const uint64_t q_desc = desc(sQ);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    const int st = j & 1, k0 = j * FWD_N;
    // the barrier also tells every thread whether all the tile's keys are
    // live (each thread reads the flag it loaded itself)
    const bool keys_live = __syncthreads_and(tid >= FWD_N || ok_flags[st * FWD_N + tid] != 0);

    // S = Q K^T over the 64 head dims: 4 steps of k16, both operands K-major
    // (s is not initialised: the first step overwrites it, and an undefined
    // value keeps the compiler from holding it live across iterations)
    const uint64_t k_desc = desc(sK + st * FWD_KV_BYTES);
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      wgmma_m64n64_ss<0, 0>(s, advance(q_desc, kk * 32), advance(k_desc, kk * 32), kk > 0);
    wg_commit();
    wg_wait();
    fence_regs(s);

    // masks and the online softmax, fp32
    float mx[2] = {m[0], m[1]};
    const TileClass cls = tile_class(q0, q0 + FWD_M - 1, k0, k0 + FWD_N - 1, p.causal, p.window);
    if (cls == ALL_LIVE && keys_live) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] *= p.scale;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else if (cls == NONE_LIVE) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = k0 + 8 * (i >> 2) + col0 + (i & 1) < p.S ? MASKED : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      const int* ok = ok_flags + st * FWD_N;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + col0 + (i & 1);
        const int key = k0 + c, t = t_row[r];
        float x = -INFINITY;  // a column past S takes no part
        if (key < p.S) {
          bool live = ok[c] != 0;
          if (p.causal) live = live && key <= t;
          if (p.window) live = live && abs(t - key) <= half_window;
          x = live ? s[i] * p.scale : MASKED;
        }
        s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      // differences first: finfo.min * log2(e) would overflow to -inf
      alpha[r] = fast_exp2((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pa[16];  // P as bf16 pairs: the A operand of P V, 4 registers per k16 step
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float e0 = fast_exp2((s[i] - m[r]) * LOG2E), e1 = fast_exp2((s[i + 1] - m[r]) * LOG2E);
      l[r] += e0 + e1;
      pa[i >> 1] = pack_bf16(e0, e1);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V over the tile's keys: 4 steps of k16, V MN-major
    const uint64_t v_desc = desc(sV + st * FWD_KV_BYTES);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_N / 16; ++kk) wgmma_m64n64_rs<1>(o, pa + 4 * kk, advance(v_desc, kk * 16 * ROW_BYTES));
    wg_commit();
    wg_wait();
    fence_regs(o);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t_row[r];
    if (t >= p.T) continue;
    const float inv = 1.f / l[r];
    bf16* out_row = p.out + ((static_cast<long long>(b) * p.T + t) * p.H + h) * HEAD_DIM;
#pragma unroll
    for (int i = 2 * r; i < 32; i += 4) {
      const int c = 8 * (i >> 2) + col0;
      *reinterpret_cast<uint32_t*>(out_row + c) = pack_bf16(o[i] * inv, o[i + 1] * inv);
    }
    // a row whose keys are all masked has m = finfo.min and l = S: its lse
    // rounds to finfo.min, which the backward reads as "no live key"
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.T + t] = m[r] + logf(l[r]);
  }
}

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* out;    // O, (B, T, H, 64) contiguous
  const bf16* dout;   // dO, (B, T, H, 64) strided
  const int* key_ok;  // (B, S) 0/1 flags, or null
  const float* lse;   // (B, H, T)
  float* delta;       // (B, H, T), written by flash_bwd_rows_sm90
  float* k_sums;      // (B, H, 65): the live keys' sum and count, zeroed, added to by flash_bwd_rows_sm90
  float* dq;          // (B, T, H, 64) contiguous fp32, zeroed, added to
  bf16* dk;           // (B, S, H, 64) contiguous
  bf16* dv;           // (B, S, H, 64) contiguous
  int B, T, S, H;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_st, g_sh;
  long long m_sb;
  int causal, window;
  float scale;
};

constexpr int ROW_THREADS = 256;
constexpr int SUM_ROWS = 64;  // keys summed by one block of flash_bwd_rows_sm90

// What the backward needs per row before it starts. Blocks below
// delta_blocks write delta[b, h, t] = sum_d dO[b, t, h, d] O[b, t, h, d], one
// warp per row; each block after them adds the live keys of SUM_ROWS rows of
// one (batch, head) to k_sums (64 sums, then the count). dQ = dS K is
// computed as dS (K - their mean): equal, since each row of the exact dS
// sums to 0, but a row of the kernel's dS sums to the rounding error of
// delta (O is bf16), and without the centring that error would reach dQ
// multiplied by the keys' common component, which in a model's attention
// can dwarf their spread.
__global__ void __launch_bounds__(ROW_THREADS) flash_bwd_rows_sm90(const BwdParams p, int delta_blocks) {
  if (static_cast<int>(blockIdx.x) < delta_blocks) {
    const long long row = (static_cast<long long>(blockIdx.x) * ROW_THREADS + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= static_cast<long long>(p.B) * p.T * p.H) return;
    const int h = static_cast<int>(row % p.H);
    const int t = static_cast<int>((row / p.H) % p.T);
    const int b = static_cast<int>(row / (static_cast<long long>(p.H) * p.T));
    const __nv_bfloat162 o = reinterpret_cast<const __nv_bfloat162*>(p.out + row * HEAD_DIM)[lane];
    const __nv_bfloat162 g =
        reinterpret_cast<const __nv_bfloat162*>(p.dout + b * p.g_sb + t * p.g_st + h * p.g_sh)[lane];
    float acc = __bfloat162float(o.x) * __bfloat162float(g.x) + __bfloat162float(o.y) * __bfloat162float(g.y);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.T + t] = acc;
    return;
  }
  constexpr int PARTS = ROW_THREADS / HEAD_DIM;  // each thread sums every PARTS-th row of the block's rows
  __shared__ float sums[ROW_THREADS], counts[ROW_THREADS];
  const int chunks = (p.S + SUM_ROWS - 1) / SUM_ROWS;
  const int block = blockIdx.x - delta_blocks, bh = block / chunks, s0 = (block % chunks) * SUM_ROWS;
  const int b = bh / p.H, h = bh % p.H;
  const int d = threadIdx.x % HEAD_DIM, part = threadIdx.x / HEAD_DIM;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh + d;
  float sum = 0.f, count = 0.f;
#pragma unroll
  for (int i = 0; i < SUM_ROWS / PARTS; ++i) {
    const int s = s0 + i * PARTS + part;
    const bool live = s < p.S && (p.key_ok == nullptr || p.key_ok[b * p.m_sb + s] != 0);
    sum += live ? __bfloat162float(k[s * p.k_ss]) : 0.f;
    count += live ? 1.f : 0.f;
  }
  sums[threadIdx.x] = sum;
  counts[threadIdx.x] = count;
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int i = 1; i < PARTS; ++i) {
      sum += sums[i * HEAD_DIM + d];
      count += counts[i * HEAD_DIM + d];
    }
    atomicAdd(p.k_sums + bh * (HEAD_DIM + 1) + d, sum);
    if (d == 0) atomicAdd(p.k_sums + bh * (HEAD_DIM + 1) + HEAD_DIM, count);
  }
}

// K - k_mean into a second tile, for dQ (the fence and barrier before the
// first dQ product publish it); stats holds the live keys' 64 sums and count.
// Not inlined: inlined into the backward kernel, this once-per-block loop
// changed the code the compiler made of the main loop and slowed it down.
__device__ __noinline__ void centre_keys(const uint8_t* tile, uint8_t* centred_tile, const float* stats, int tid) {
  const float inv_count = stats[HEAD_DIM] > 0.f ? 1.f / stats[HEAD_DIM] : 0.f;
  for (int idx = tid; idx < BWD_N * 8; idx += BWD_THREADS) {
    const uint32_t at = swizzled(idx >> 3, idx & 7);
    const uint4 in = *reinterpret_cast<const uint4*>(tile + at);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&in);
    const float* sum = stats + (idx & 7) * 8;
    uint4 centred;
    uint32_t* y = reinterpret_cast<uint32_t*>(&centred);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(x[u]);
      y[u] = pack_bf16(f.x - sum[2 * u] * inv_count, f.y - sum[2 * u + 1] * inv_count);
    }
    *reinterpret_cast<uint4*>(centred_tile + at) = centred;
  }
}

constexpr int BWD_KV_BYTES = BWD_N * ROW_BYTES;  // 16 KB
constexpr int BWD_Q_BYTES = BWD_M * ROW_BYTES;   // 8 KB a stage of q or dO
constexpr int BWD_DS_BYTES = BWD_N * ROW_BYTES;  // dS^T: 128 key rows x 64 queries, bf16
constexpr int BWD_SMEM = 3 * BWD_KV_BYTES + 4 * BWD_Q_BYTES + BWD_DS_BYTES + 4 * BWD_M * 4 + 1024;

__global__ void __launch_bounds__(BWD_THREADS, 1) flash_bwd_sm90_kernel(const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sKc = sK + BWD_KV_BYTES;      // K - k_mean, for dQ
  const uint32_t sV = sKc + BWD_KV_BYTES;
  const uint32_t sQ = sV + BWD_KV_BYTES;       // stage s at sQ + s * BWD_Q_BYTES
  const uint32_t sG = sQ + 2 * BWD_Q_BYTES;    // dO, likewise
  const uint32_t sDS = sG + 2 * BWD_Q_BYTES;   // dS^T, [key][query], swizzled
  const uint32_t sL = sDS + BWD_DS_BYTES;      // lse, [2][BWD_M] float
  const uint32_t sD = sL + 2 * BWD_M * 4;      // delta, [2][BWD_M] float
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* delta_s = reinterpret_cast<const float*>(smem_raw + (sD - raw));
  uint8_t* ds_bytes = smem_raw + (sDS - raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int k0 = blockIdx.x * BWD_N;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* g = p.dout + b * p.g_sb + h * p.g_sh;
  const float* lse = p.lse + static_cast<long long>(blockIdx.y) * p.T;
  const float* delta = p.delta + static_cast<long long>(blockIdx.y) * p.T;
  const int n_tiles = (p.T + BWD_M - 1) / BWD_M;

  auto load_q = [&](int i) {
    const int st = i & 1, q0 = i * BWD_M;
    load_tile<BWD_M, BWD_THREADS>(sQ + st * BWD_Q_BYTES, q, p.q_st, q0, p.T, tid);
    load_tile<BWD_M, BWD_THREADS>(sG + st * BWD_Q_BYTES, g, p.g_st, q0, p.T, tid);
    if (tid < 2 * BWD_M) {
      const int c = tid & (BWD_M - 1), t = q0 + c;
      const float* src = tid < BWD_M ? lse : delta;
      cp_async4((tid < BWD_M ? sL : sD) + (st * BWD_M + c) * 4, src + (t < p.T ? t : 0), t < p.T);
    }
  };

  load_tile<BWD_N, BWD_THREADS>(sK, k, p.k_ss, k0, p.S, tid);
  load_tile<BWD_N, BWD_THREADS>(sV, v, p.v_ss, k0, p.S, tid);
  cp_async_commit();
  load_q(0);
  cp_async_commit();

  // this thread's two key rows (within the block) and its first column in
  // each 8-column group
  const int row = wg * 64 + warp * 16 + (lane >> 2);
  int s_row[2];
  bool s_in[2], s_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s_row[r] = k0 + row + 8 * r;
    s_in[r] = s_row[r] < p.S;
    s_ok[r] = s_in[r] && (p.key_ok == nullptr || p.key_ok[b * p.m_sb + s_row[r]] != 0);
  }
  const int col0 = 2 * (lane & 3);
  const int half_window = p.window / 2;
  const float uniform = 1.f / p.S;  // P of every key in a row whose keys are all masked
  const float scale_log2 = p.scale * LOG2E;
  cp_async_wait<1>();  // K and V have arrived (the barrier below shows every thread's copies)
  const bool keys_live = __syncthreads_and(s_ok[0] && s_ok[1]);  // every key of the block in range and unmasked
  centre_keys(smem_raw + (sK - raw), smem_raw + (sKc - raw),
              p.k_sums + static_cast<long long>(blockIdx.y) * (HEAD_DIM + 1), tid);
  const uint64_t k_desc = desc(sK + wg * 64 * ROW_BYTES);
  const uint64_t v_desc = desc(sV + wg * 64 * ROW_BYTES);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_q(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int st = it & 1, q0 = it * BWD_M;
    const uint32_t q_tile = sQ + st * BWD_Q_BYTES, g_tile = sG + st * BWD_Q_BYTES;

    // S^T = K Q^T and dP^T = V dO^T over the head dims, all K-major (the
    // accumulators of products that start from zero are left undefined, as
    // s in the forward)
    const uint64_t q_desc = desc(q_tile), g_desc = desc(g_tile);
    float sacc[32], dpacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      wgmma_m64n64_ss<0, 0>(sacc, advance(k_desc, kk * 32), advance(q_desc, kk * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      wgmma_m64n64_ss<0, 0>(dpacc, advance(v_desc, kk * 32), advance(g_desc, kk * 32), kk > 0);
    wg_commit();
    wg_wait();
    fence_regs(sacc);
    fence_regs(dpacc);

    // P and dS in fp32; bf16 copies as A operands, and dS^T to shared memory
    const float* lse_t = lse_s + st * BWD_M;
    const float* delta_t = delta_s + st * BWD_M;
    const TileClass cls = tile_class(q0, q0 + BWD_M - 1, k0, k0 + BWD_N - 1, p.causal, p.window);
    const bool all_live = cls == ALL_LIVE && keys_live && q0 + BWD_M <= p.T;
    uint32_t pa[16], da[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + col0;
      float pv[2], dsv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float L = lse_t[c + u];
        if (all_live) {
          pv[u] = fast_exp2(sacc[i + u] * scale_log2 - L * LOG2E);
          dsv[u] = pv[u] * (dpacc[i + u] - delta_t[c + u]);
          continue;
        }
        const int t = q0 + c + u;
        const bool t_in = t < p.T;
        bool live = cls != NONE_LIVE && s_ok[r] && t_in;
        if (p.causal) live = live && s_row[r] <= t;
        if (p.window) live = live && abs(t - s_row[r]) <= half_window;
        float P = 0.f;  // masked in-range entries: 0, or 1/S in a row with no live key
        if (s_in[r] && t_in)
          P = live ? fast_exp2(sacc[i + u] * scale_log2 - L * LOG2E) : (L < ALL_MASKED ? uniform : 0.f);
        pv[u] = P;
        dsv[u] = live ? P * (dpacc[i + u] - delta_t[c + u]) : 0.f;
      }
      pa[i >> 1] = pack_bf16(pv[0], pv[1]);
      da[i >> 1] = pack_bf16(dsv[0], dsv[1]);
      const int key_row = row + 8 * r;
      *reinterpret_cast<uint32_t*>(ds_bytes + swizzled(key_row, c >> 3) + (c & 7) * 2) = da[i >> 1];
    }

    // dV += P^T dO and dK += dS^T Q over the 64 queries; dO and Q MN-major
    fence_regs(dv);
    fence_regs(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_M / 16; ++kk)
      wgmma_m64n64_rs<1>(dv, pa + 4 * kk, advance(desc(g_tile), kk * 16 * ROW_BYTES));
#pragma unroll
    for (int kk = 0; kk < BWD_M / 16; ++kk)
      wgmma_m64n64_rs<1>(dk, da + 4 * kk, advance(desc(q_tile), kk * 16 * ROW_BYTES));
    wg_commit();
    wg_wait();
    fence_regs(dv);
    fence_regs(dk);
    fence_async_smem();
    __syncthreads();  // every key row of dS^T is in shared memory; Q and dO of stage st are free

    // dQ[:, 32 wg : 32 wg + 32] = dS (K - k_mean) over the block's 128 keys:
    // dS^T and the centred K are both read MN-major, K from this
    // warpgroup's 32 columns
    float dqacc[DQ_N / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_N / 16; ++kk)
      wgmma_m64n32_ss<1, 1>(dqacc, advance(desc(sDS), kk * 16 * ROW_BYTES),
                            advance(desc(sKc + wg * DQ_N * 2), kk * 16 * ROW_BYTES), kk > 0);
    wg_commit();
    wg_wait();
    fence_regs(dqacc);
    // lanes l and l ^ 1 hold 4 neighbouring columns of one row in each
    // 8-column group j; they trade halves so that the even lane adds group
    // j's 4 columns and the odd lane group j + 1's, 16 bytes each
    const bool odd = lane & 1;
    const int c_even = 2 * (lane & 2);  // first of the pair's 4 columns in a group
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + warp * 16 + (lane >> 2) + 8 * r;
      float* dq_row = p.dq + ((static_cast<long long>(b) * p.T + (t < p.T ? t : 0)) * p.H + h) * HEAD_DIM + wg * DQ_N;
#pragma unroll
      for (int j = 0; j < DQ_N / 8; j += 2) {
        const int a = 4 * j + 2 * r, c = 4 * (j + 1) + 2 * r;  // this row's pairs in groups j and j + 1
        const float gx = __shfl_xor_sync(0xffffffffu, odd ? dqacc[a] : dqacc[c], 1);
        const float gy = __shfl_xor_sync(0xffffffffu, odd ? dqacc[a + 1] : dqacc[c + 1], 1);
        const float4 add =
            odd ? make_float4(gx, gy, dqacc[c], dqacc[c + 1]) : make_float4(dqacc[a], dqacc[a + 1], gx, gy);
        if (t < p.T)
          atomicAdd(reinterpret_cast<float4*>(dq_row + 8 * (j + odd) + c_even),
                    make_float4(add.x * p.scale, add.y * p.scale, add.z * p.scale, add.w * p.scale));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!s_in[r]) continue;
    const long long at = ((static_cast<long long>(b) * p.S + s_row[r]) * p.H + h) * HEAD_DIM;
#pragma unroll
    for (int i = 2 * r; i < 32; i += 4) {
      const int c = 8 * (i >> 2) + col0;
      *reinterpret_cast<uint32_t*>(p.dk + at + c) = pack_bf16(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + at + c) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

}  // namespace

extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, const void* key_ok, void* out,
                                        void* lse, int B, int T, int S, int H, int D, long long q_sb, long long q_st,
                                        long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                        long long v_ss, long long v_sh, long long m_sb, int causal, int window,
                                        float scale, void* stream) {
  if (D != HEAD_DIM || B <= 0 || H <= 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const FwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<const int*>(key_ok), static_cast<bf16*>(out), static_cast<float*>(lse),
                    B, T, S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, causal, window, scale};
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + FWD_M - 1) / FWD_M, B * H);
  flash_fwd_sm90_kernel<<<grid, WG_THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// dq and k_sums (B * H * 65 floats) must be zeroed by the caller; delta
// (B * H * T floats) is scratch.
extern "C" int flash_attention_sm90_bwd(const void* q, const void* k, const void* v, const void* key_ok,
                                        const void* out, const void* dout, const void* lse, void* delta,
                                        void* k_sums, void* dq, void* dk, void* dv, int B, int T, int S, int H, int D,
                                        long long q_sb, long long q_st, long long q_sh, long long k_sb,
                                        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                        long long v_sh, long long g_sb, long long g_st, long long g_sh,
                                        long long m_sb, int causal, int window, float scale, void* stream) {
  if (D != HEAD_DIM || B <= 0 || H <= 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const BwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<const int*>(key_ok),
                    static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(k_sums),
                    static_cast<float*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    B, T, S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_st, g_sh, m_sb,
                    causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * T * H;
  const int delta_blocks = static_cast<int>((rows * 32 + ROW_THREADS - 1) / ROW_THREADS);
  const int sum_blocks = B * H * ((S + SUM_ROWS - 1) / SUM_ROWS);
  flash_bwd_rows_sm90<<<delta_blocks + sum_blocks, ROW_THREADS, 0, s>>>(p, delta_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BWD_N - 1) / BWD_N, B * H);
  flash_bwd_sm90_kernel<<<grid, BWD_THREADS, BWD_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
