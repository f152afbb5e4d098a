// Int8 weight-only matrix product for Hopper (sm_90a): kernel D.
//
// Replaces the Pallas kernel mapperatorinator_tpu/ops/qmm_kernel.py:
// _qmm_kernel, launched by qmm. Computes
//   out[r, n] = (sum_k x[r, k] * float(wq[k, n])) * scale[n]
// with x (rows, K) fp32 or bf16, wq (K, N) int8 in row-major (the JAX
// QDense layout, N contiguous), scale (N,) fp32: the int8 weight crosses
// device memory as int8 and is upcast on the chip, the sum is fp32, the
// per-column scale is applied once in fp32, and the output is rounded to x's
// dtype.
//
// Two kernels behind one entry point, chosen by the row count:
//
// * rows <= 4 (a decode step: batch 1, or 2 with CFG): a GEMV. One block
//   owns 32 output columns and 128 threads split K between them; each thread
//   reads 16 int8 weights of one row k as one 16-byte vector along N, so a
//   warp reads 16 rows x 32 contiguous bytes, whole 32-byte sectors. The
//   partial sums are reduced over K with warp shuffles, then across the
//   block's warps in shared memory, scaled and stored.
//   What bounds it: streaming K*N int8 bytes, 2.36 MB for fc1 (768 x 3072),
//   0.70 us at 3.35 TB/s, so the launch latency of a few microseconds
//   dominates, and the grid (N / 32 blocks: 24 to 96 at v32's widths) does
//   not fill the 132 SMs. A split over K across blocks would help the bytes,
//   not the launch.
//
// * more rows (the encoder's 1024-row windows, init_cache, a prefill): a
//   GEMM on the tensor cores (qmm_tc_kernel).
//   What bounds it: at 1024 x 768 x 3072 it is 4.83 GFLOP against 18 MB of
//   x, weight and output in fp32, so operations. On fp32 FMAs the floor is
//   0.072 ms; on the tensor cores one TF32 product of the whole shape takes
//   0.0098 ms at 495 TFLOP/s, one bf16 product 0.0049 ms at 989.
//   Exactness: every int8 value is exact in TF32 (11 significant bits) and in
//   bf16 (8), so the weight is never split. A bf16 x times the weight is one
//   exact bf16 product (mma.sync m16n8k16, fp32 accumulators). An fp32 x is
//   split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties
//   away from zero, as cvt.rna.tf32.f32), and x w = hi w + lo w: two TF32
//   products (mma.sync m16n8k8) where fp32 attention needs three, since w has
//   no lo part. The tensor cores' own sums truncate, so a sum kept in their
//   accumulators along K drifts: the big products hi w of each k tile (TC_BK
//   deep) sum in fresh accumulators, added to the running sums in fp32; the
//   small ones lo w, 2^-11 of the big, run along K in the tensor cores. The
//   rounding-faithful plain version is ops/qmm_kernel.py:qmm_plain_tf32x2.
//   Design: a block computes a TC_BM x TC_BN (64 x 64) output tile with 4
//   warps, each a 32 x 32 warp tile (2 x 4 mma tiles). x tiles (TC_BM x
//   TC_BK, 64 deep) and int8 weight tiles (TC_BK x TC_BN) arrive by cp.async,
//   16 bytes a thread, in a TC_STAGES-deep (4) ring, zero-filled past M, K
//   and N, so the next tiles are in flight while the tensor cores work. A
//   warp's n index is permuted (mma tile j, fragment column c is the warp
//   tile's column 4c + j): a lane's B values of its four n tiles are then one
//   32-bit word of an int8 row, upcast by byte permutes and one fp32 add each
//   (exact, no int-to-float conversions), and its outputs of a row are 8
//   adjacent columns, stored as 16-byte vectors. Rows are padded (x: TC_BK +
//   16 bytes; weight: TC_BN + 32 bytes for fp32 x, + 16 for bf16) so every
//   fragment read is free of bank conflicts. The epilogue scales in fp32 and
//   rounds to x's dtype.
//   Tried on the H100 and not kept (device times at the encoder shapes): a
//   128 x 64 or 128 x 128 block tile, 64 x 32 warp tiles, a k tile of 32,
//   3 stages, fresh fp32 accumulators every k step, and upcasting the weight
//   tile once per block into shared memory (a second barrier a k tile): each
//   as fast or slower in fp32.
//
// K needs no alignment (K = 200 works; where K is not a whole number of 16
// bytes of x, the x tiles are loaded element by element); N must be a
// multiple of 16 and the weight 16-byte aligned, which the Python wrapper
// checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// ---- GEMV: rows <= 4 ------------------------------------------------------

constexpr int GV_TX = 2;                  // threads along N, 16 columns each
constexpr int GV_TY = 128;                // threads along K
constexpr int GV_THREADS = GV_TX * GV_TY; // 256
constexpr int GV_BN = GV_TX * 16;         // 32 columns a block
constexpr int GV_WARPS = GV_THREADS / 32;

template <typename T, int R>
__global__ void __launch_bounds__(GV_THREADS)
    qmm_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                    T* __restrict__ out, int K, int N) {
  __shared__ float red[GV_WARPS][R][GV_BN];
  const int tid = threadIdx.x;
  const int tx = tid % GV_TX, ty = tid / GV_TX;
  const int nb = blockIdx.x * GV_BN;
  const int n0 = nb + tx * 16;

  float acc[R][16];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;

  if (n0 < N) {  // N is a multiple of 16: a thread's 16 columns are all in or all out
    for (int k = ty; k < K; k += GV_TY) {
      const int4 packed = __ldg(reinterpret_cast<const int4*>(w + static_cast<long long>(k) * N + n0));
      const int8_t* q = reinterpret_cast<const int8_t*>(&packed);
      float xr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xr[r] = to_float(x[static_cast<long long>(r) * K + k]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float wf = static_cast<float>(q[j]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][j] = fmaf(xr[r], wf, acc[r][j]);
      }
    }
  }

  // lane = (ty % 16) * GV_TX + tx: the K threads of a warp differ in lane bits 1..4
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int off = 16; off >= GV_TX; off >>= 1) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);

  const int warp = tid / 32, lane = tid % 32;
  if (lane < GV_TX) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][r][lane * 16 + j] = acc[r][j];
  }
  __syncthreads();

  for (int i = tid; i < R * GV_BN; i += GV_THREADS) {
    const int r = i / GV_BN, c = i % GV_BN;
    const int n = nb + c;
    if (n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < GV_WARPS; ++wi) s += red[wi][r][c];
    out[static_cast<long long>(r) * N + n] = from_float<T>(s * scale[n]);
  }
}

// ---- tensor cores: more rows ----------------------------------------------

constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 64;  // block tile; k tile
constexpr int TC_WM = 32, TC_WN = 32;               // warp tile
constexpr int TC_STAGES = 4;                        // cp.async ring depth
constexpr int TC_WARPS_N = TC_BN / TC_WN;
constexpr int TC_THREADS = 32 * (TC_BM / TC_WM) * TC_WARPS_N;
constexpr int TC_MT = TC_WM / 16, TC_NT = TC_WN / 8;  // mma tiles a warp
static_assert(TC_NT == 4, "a lane reads the B values of its four n tiles as one word");

// elements a row of the x tile in shared memory: TC_BK and 16 bytes of padding
template <typename T>
constexpr int TC_LDX = TC_BK + 16 / static_cast<int>(sizeof(T));

// bytes a row of the weight tile in shared memory, padded so that the B
// fragment reads are free of bank conflicts: an fp32 step reads rows t, 24
// words apart (banks 0, 24, 16, 8), a bf16 step rows 2t, 2 x 20 words apart
// (banks 0, 8, 16, 24), each lane a word of 8 adjacent ones
template <typename T>
constexpr int TC_LDW = TC_BN + (std::is_same<T, float>::value ? 32 : 16);

template <typename T>
constexpr int TC_SMEM = TC_STAGES * (TC_BM * TC_LDX<T> * static_cast<int>(sizeof(T)) + TC_BK * TC_LDW<T>);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes where !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
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

// The four int8 values of a word as fp32, exactly and without the
// quarter-rate int-to-float unit: byte b of q ^ 0x80808080 is q_b + 128, and
// as the low mantissa byte of 2^23 it gives the float 2^23 + 128 + q_b.
__device__ __forceinline__ void int8x4_to_float(uint32_t q, float (&f)[4]) {
  const uint32_t u = q ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
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

// d += a b, m16n8k16, bf16 operands (two to a register, the lower index in
// the low half), fp32 accumulators: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g,
// 2t+8..), a3 (g + 8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n
// g); d as for m16n8k8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The k tile at k0 into one stage of the ring: x rows [m0, m0 + TC_BM) and
// weight columns [n0, n0 + TC_BN), zero past M, K and N. VEC: x's rows are
// whole 16-byte chunks (K a multiple of 16 / sizeof(T), x 16-byte aligned),
// so every x chunk lies all in or all out of K and goes by cp.async;
// otherwise x goes element by element through registers. The weight always
// goes by cp.async: N is a multiple of 16 and the weight 16-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* xs, int8_t* ws, const T* __restrict__ x, const int8_t* __restrict__ w,
                                          int M, int K, int N, int m0, int n0, int k0, int tid) {
  constexpr int LD = TC_LDX<T>;
  constexpr int EV = 16 / static_cast<int>(sizeof(T));  // x elements a chunk
  constexpr int XCH = TC_BK / EV;                       // chunks a row of the x tile
  for (int i = tid; i < TC_BM * XCH; i += TC_THREADS) {
    const int r = i / XCH, c = (i % XCH) * EV;
    const int gm = m0 + r, gk = k0 + c;
    T* dst = xs + r * LD + c;
    if constexpr (VEC) {
      const bool ok = gm < M && gk < K;
      cp_async16(dst, ok ? x + static_cast<long long>(gm) * K + gk : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e)
        dst[e] = (gm < M && gk + e < K) ? x[static_cast<long long>(gm) * K + gk + e] : from_float<T>(0.f);
    }
  }
  constexpr int WCH = TC_BN / 16;  // chunks a row of the weight tile
  for (int i = tid; i < TC_BK * WCH; i += TC_THREADS) {
    const int r = i / WCH, c = (i % WCH) * 16;
    const int gk = k0 + r, gn = n0 + c;
    const bool ok = gk < K && gn < N;
    cp_async16(ws + r * TC_LDW<T> + c, ok ? w + static_cast<long long>(gk) * N + gn : w, ok);
  }
}

// A warp's n index: mma tile j, fragment column c is the warp tile's column
// 4c + j, so a lane's B values of the four tiles are four adjacent bytes (one
// word) of a weight row, and its outputs of a row are 8 adjacent columns.

// The products of one k tile for a warp, fp32 x: per step of 8, hi w into
// big, fresh at the tile's start and added to acc in fp32 at its end, and
// lo w into small, along the whole K.
__device__ __forceinline__ void tile_products(const float* xt, const int8_t* wt, int wm, int wn, int g, int t,
                                              float (&acc)[TC_MT][TC_NT][4], float (&small)[TC_MT][TC_NT][4]) {
  constexpr int LD = TC_LDX<float>, LDW = TC_LDW<float>;
  float big[TC_MT][TC_NT][4];
#pragma unroll
  for (int ks = 0; ks < TC_BK / 8; ++ks) {
    const int k = ks * 8;
    // int8 -> fp32 is exact and already a TF32 value
    float w0[4], w1[4];
    const int8_t* q = wt + (k + t) * LDW + wn + 4 * g;
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(q), w0);
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(q + 4 * LDW), w1);
    uint32_t b[TC_NT][2];
#pragma unroll
    for (int j = 0; j < TC_NT; ++j) b[j][0] = __float_as_uint(w0[j]), b[j][1] = __float_as_uint(w1[j]);
#pragma unroll
    for (int i = 0; i < TC_MT; ++i) {
      const float* a = xt + (wm + 16 * i + g) * LD + k + t;
      uint32_t hi[4], lo[4];
      split(a[0], hi[0], lo[0]);
      split(a[8 * LD], hi[1], lo[1]);
      split(a[4], hi[2], lo[2]);
      split(a[8 * LD + 4], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < TC_NT; ++j) {
        mma_tf32(small[i][j], lo, b[j]);
        if (ks == 0)
          mma_tf32_first(big[i][j], hi, b[j]);
        else
          mma_tf32(big[i][j], hi, b[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TC_MT; ++i)
#pragma unroll
    for (int j = 0; j < TC_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += big[i][j][e];
}

// The products of one k tile for a warp, bf16 x: one exact bf16 product a
// step of 16, summed in acc.
__device__ __forceinline__ void tile_products(const __nv_bfloat16* xt, const int8_t* wt, int wm, int wn, int g,
                                              int t, float (&acc)[TC_MT][TC_NT][4], float (&)[TC_MT][TC_NT][4]) {
  constexpr int LD = TC_LDX<__nv_bfloat16>, LDW = TC_LDW<__nv_bfloat16>;
#pragma unroll
  for (int ks = 0; ks < TC_BK / 16; ++ks) {
    const int k = ks * 16;
    float w[4][4];  // rows k + 2t, + 1, + 8, + 9
    const int8_t* q = wt + (k + 2 * t) * LDW + wn + 4 * g;
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(q), w[0]);
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(q + LDW), w[1]);
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(q + 8 * LDW), w[2]);
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(q + 9 * LDW), w[3]);
    uint32_t b[TC_NT][2];
#pragma unroll
    for (int j = 0; j < TC_NT; ++j) b[j][0] = bf16_pair(w[0][j], w[1][j]), b[j][1] = bf16_pair(w[2][j], w[3][j]);
#pragma unroll
    for (int i = 0; i < TC_MT; ++i) {
      const __nv_bfloat16* a = xt + (wm + 16 * i + g) * LD + k + 2 * t;
      const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(a), *reinterpret_cast<const uint32_t*>(a + 8 * LD),
                              *reinterpret_cast<const uint32_t*>(a + 8),
                              *reinterpret_cast<const uint32_t*>(a + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < TC_NT; ++j) mma_bf16(acc[i][j], af, b[j]);
    }
  }
}

// 8 adjacent outputs, rounded to T: 32 bytes (fp32) or 16 (bf16)
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 packed;
  packed.x = bf16_pair(v[0], v[1]);
  packed.y = bf16_pair(v[2], v[3]);
  packed.z = bf16_pair(v[4], v[5]);
  packed.w = bf16_pair(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = packed;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
    qmm_tc_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                  T* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = TC_BM * TC_LDX<T>;  // elements of an x stage
  constexpr int WS = TC_BK * TC_LDW<T>;  // bytes of a weight stage
  T* xs = reinterpret_cast<T*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + TC_STAGES * XS * sizeof(T));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / TC_WARPS_N) * TC_WM, wn = (warp % TC_WARPS_N) * TC_WN;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int nk = (K + TC_BK - 1) / TC_BK;

  float acc[TC_MT][TC_NT][4], small[TC_MT][TC_NT][4];
#pragma unroll
  for (int i = 0; i < TC_MT; ++i)
#pragma unroll
    for (int j = 0; j < TC_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = small[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) load_tile<T, VEC>(xs + s * XS, ws + s * WS, x, w, M, K, N, m0, n0, s * TC_BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // ... for every thread, and all are done with tile kt - 1's stage
    const int next = kt + TC_STAGES - 1;
    if (next < nk) {
      const int s = next % TC_STAGES;
      load_tile<T, VEC>(xs + s * XS, ws + s * WS, x, w, M, K, N, m0, n0, next * TC_BK, tid);
    }
    cp_async_commit();
    const int s = kt % TC_STAGES;
    tile_products(xs + s * XS, ws + s * WS, wm, wn, g, t, acc, small);
  }

  // lane (g, t) holds, for rows g and g + 8 of each mma tile i, the warp
  // tile's columns 8t .. 8t + 7: d0 of tile j is column 8t + j, d1 8t + 4 + j
  const int n = n0 + wn + 8 * t;
  if (n >= N) return;  // N is a multiple of 16: the 8 columns are all in or all out
  float sc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) sc[c] = __ldg(scale + n + c);
#pragma unroll
  for (int i = 0; i < TC_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < TC_NT; ++j) {
        v[j] = acc[i][j][2 * h];
        v[4 + j] = acc[i][j][2 * h + 1];
        if constexpr (std::is_same<T, float>::value) {
          v[j] += small[i][j][2 * h];
          v[4 + j] += small[i][j][2 * h + 1];
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] *= sc[c];
      store8(out + static_cast<long long>(m) * N + n, v);
    }
}

template <typename T, bool VEC>
cudaError_t launch_tc(const T* x, const int8_t* w, const float* scale, T* out, int rows, int K, int N,
                      cudaStream_t stream) {
  constexpr int smem = TC_SMEM<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(qmm_tc_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (rows + TC_BM - 1) / TC_BM);
  qmm_tc_kernel<T, VEC><<<grid, TC_THREADS, smem, stream>>>(x, w, scale, out, rows, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int rows, int K, int N,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  const int gv_grid = (N + GV_BN - 1) / GV_BN;
  switch (rows) {
    case 1: qmm_gemv_kernel<T, 1><<<gv_grid, GV_THREADS, 0, stream>>>(xp, wp, sp, op, K, N); break;
    case 2: qmm_gemv_kernel<T, 2><<<gv_grid, GV_THREADS, 0, stream>>>(xp, wp, sp, op, K, N); break;
    case 3: qmm_gemv_kernel<T, 3><<<gv_grid, GV_THREADS, 0, stream>>>(xp, wp, sp, op, K, N); break;
    case 4: qmm_gemv_kernel<T, 4><<<gv_grid, GV_THREADS, 0, stream>>>(xp, wp, sp, op, K, N); break;
    default: {
      const bool vec = K % (16 / static_cast<int>(sizeof(T))) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
      return vec ? launch_tc<T, true>(xp, wp, sp, op, rows, K, N, stream)
                 : launch_tc<T, false>(xp, wp, sp, op, rows, K, N, stream);
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int qmm_fwd(const void* x, const void* w, const void* scale, void* out, int rows, int K, int N,
                       int bf16, void* stream) {
  if (rows <= 0 || K <= 0 || N <= 0 || N % 16) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(x, w, scale, out, rows, K, N, s)
                               : launch<float>(x, w, scale, out, rows, K, N, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
