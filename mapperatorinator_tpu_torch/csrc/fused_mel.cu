// Fused mel spectrogram for Hopper (sm_90a): kernel A.
//
// Replaces the Pallas kernel mapperatorinator_tpu/ops/mel_kernel.py:
// _mel_kernel, launched by fused_mel. Computes, per frame,
//   mel = ((frame @ W_re)^2 + (frame @ W_im)^2) @ fbanks, then log1p when asked:
// the window-folded real DFT as two matrix products, the power spectrum, the
// (n_freqs, n_mels) filterbank. W_re, W_im and fbanks are general fp32
// matrices: no window, FFT structure or filterbank sparsity is assumed.
//
// What bounds it on an H100. A v32 window is 2048 frames, 1024 -> 513 ->
// 128: 4.30 GFLOP of DFT products and 0.27 of projection, against about 1 MB
// of signal, 4.2 MB of DFT matrices and 1 MB of mels: operations. On fp32
// FMAs the floor is 0.068 ms. The reference computes at Precision.HIGHEST,
// and one TF32 product keeps 10 mantissa bits (a relative error of 2^-11 an
// operand): with one TF32 product the mels miss the fp32 bars. So every
// product runs on the tensor cores as three TF32 products of split operands,
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away from zero,
// as cvt.rna.tf32.f32), a.b = hi.hi' + (hi.lo' + lo.hi'): 13.7 GFLOP of TF32
// work, 0.028 ms at the published 495 TFLOP/s, which only wgmma reaches.
// This kernel issues mma.sync, which runs below that rate: wgmma would need
// W split ahead into the tensor cores' shared-memory layout, and the
// frames, which overlap, copied out of the signal once per frame. The
// tensor cores' own fp32 sums truncate, so a sum kept in their accumulators
// along a whole contraction drifts: each chain of four k steps (32 samples,
// or 32 bins) sums in fresh accumulators, which are added to the running
// sums in fp32. The rounding-faithful plain version is
// ops/mel_kernel.py:mel_plain_tf32x3.
//
// Design.
// * Grid: a tile of TM = 64 frames of one batch item times a slice of at
//   most SLICE = 80 bins; the slices of a tile are the blocks of one
//   thread-block cluster (ops/mel_kernel.py:mel_plan: 513 bins are 7 slices
//   of 80, so a 2048-frame window is 32 tiles x 7 = 224 blocks). Two blocks
//   share an SM (107 KB of shared memory and 128 threads of 253 registers
//   each at the v32 shape), so the 224 blocks run in one wave on the 132 SMs.
//   A block reads only its slice of W, about 32 full W reads a window. Tiles
//   never cross a batch boundary (the last tile of an item may be short),
//   so a tile's frames are one strided run of the signal.
// * Frames are read once, from the signal. Frame m of a tile starts h
//   floats after frame m - 1 (h: the frame stride, the hop of the unfold
//   view), so the tile's frames span (TM - 1) h + n_fft samples, 36 KB at the
//   v32 shape against the 256 KB of the frames it holds. The block copies
//   that span into shared memory once (cp.async, 4 bytes a copy, zero past
//   the tile's last frame), splits each sample once into a hi and a lo
//   array, and reads every A fragment from them, straight into the
//   registers the mma takes.
//   The arrays are skewed: 4 floats of padding after every h samples, so
//   frame m's sample k lies at m (h + 4) + k + 4 floor(k / h); with h a
//   multiple of 16, h + 4 is 4 modulo 16, the eight rows of a fragment read
//   fall on distinct banks, and the padding falls between k tiles. Another
//   frame stride, or a span that does not fit (contiguous frames of 1024
//   samples: 256 KB), is refused by the wrapper with a ValueError.
// * W streams through a three-stage cp.async ring of 16-sample k tiles, 4
//   bytes a copy: a row of 513 floats is not 16-byte aligned, nor could a
//   TMA tensor map take its stride. A stage's row holds the slice's bins in
//   groups of four, the four re columns then the four im ones, so an
//   8-column mma tile is 4 bins, and a thread's accumulator pair (columns
//   2t, 2t + 1) is the re and im of one bin: the power is formed in
//   registers and reaches shared memory only as the projection's A operand.
//   Rows are 168 floats (8 modulo 32): conflict-free B fragment reads. The
//   columns outside the slice are zeroed once and never copied.
// * DFT: 4 warps, each every frame of the tile (4 m tiles) times a quarter
//   of the slice (20 bins, 5 n tiles): each W value is read and split by one
//   lane of one warp and serves 4 m tiles, three mma.sync.m16n8k8 products
//   each. With 253 registers a thread, the 20 tiles' running sums and fresh
//   accumulators stay in registers.
// * Projection: the block's power (TM x SLICE, split on the fly) times its
//   slice of fbanks (SLICE x 128 mels a chunk, staged by cp.async) on the
//   tensor cores, split the same way: a partial mel tile of TM x 128 per
//   block, in shared memory. The cluster then sums the partials through
//   distributed shared memory: rank r adds the partials of its rows of the
//   tile in rank order (no atomics: two calls give the same bits), applies
//   log1p and stores whole rows of mels (coalesced, where a split by mels
//   would store short runs). Two cluster barriers a chunk: the partials are
//   visible, then no longer read.
// * The host entry sets the shared-memory attribute once per size and
//   device, not per launch; the wrapper binds it once.
// Tried on the H100 and not kept (development builds timed beside this
// one): 8 warps of 2 x 5 tiles, or of 2 x 5 tiles with all warps copying W
// (128 registers: spills, slower); the span's hi and lo interleaved and read
// as one 8-byte load (the pair lands in adjacent registers, and the mma's A
// quad needs a register move for each value: slower); chains of 2 or 8 k
// steps (no change); cvt.rna.tf32.f32 for the split, 16-byte copies of the
// span and of the filterbank, and a cluster sum in 16-byte loads (each
// within a few microseconds, none worth a second code path).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 4;                // each owns every frame of the tile and a quarter of the slice
constexpr int THREADS = 32 * WARPS;
constexpr int TM = 64;                  // frames a tile
constexpr int MT = TM / 16;             // m tiles a warp
constexpr int SLICE = 80;               // bins a block at most (ops/mel_kernel.py MEL_SLICE)
constexpr int NTW = SLICE / 4 / WARPS;  // DFT n tiles a warp (4 bins each)
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int BK = 16;                  // samples a k tile of the W ring
constexpr int STAGES = 3;               // the W ring's depth
constexpr int CHAIN = 2;                // k tiles (4 k steps) summed in fresh accumulators before an fp32 add
constexpr int PAD = 4;                  // floats of padding after every h samples of the span
constexpr int LDW = 2 * SLICE + 8;      // floats a ring row: re and im of the slice, 8 modulo 32
constexpr int MCH = 128;                // mels a projection chunk
constexpr int PNT = MCH / 8 / WARPS;    // projection n tiles a warp
constexpr int LDP = SLICE + 4;          // power rows: 4 modulo 8
constexpr int LDF = MCH + 8;            // filterbank rows: 8 modulo 32
constexpr int LDQ = MCH + 8;            // partial-mel rows
constexpr int SLOT = BK * LDW * 4;      // bytes a ring stage
constexpr int RING = STAGES * BK * LDW;                 // floats
constexpr int PROJ = TM * LDP + SLICE * LDF + TM * LDQ;  // floats
constexpr int MAX_SMEM = 232448;                         // bytes a block may have on an H100
static_assert(NTW * 4 * WARPS == SLICE && PNT * 8 * WARPS == MCH, "the warps cover the slice and a chunk");

struct Params {
  const float* frames;  // (B, n_frames, n_fft) through s_batch and h, unit last stride
  const float* w_re;    // (n_fft, n_freqs)
  const float* w_im;    // (n_fft, n_freqs)
  const float* fb;      // (n_freqs, n_mels)
  float* out;           // (B, n_frames, n_mels)
  long long s_batch;
  int h;                // frame stride, a multiple of BK
  int n_frames, tiles;  // frames of an item, tiles of an item
  int n_fft, n_freqs, n_mels;
  int nb;               // bins a slice (a multiple of 8, at most SLICE)
  int log_scale;
  int span;             // samples staged a tile: (TM - 1) h + the k tiles' samples
  int spanf;            // floats of each skewed span array (hi, lo), a multiple of 4
};

// the k tiles of n_fft (whole chains), the samples of a span and the floats of each of its arrays
__host__ __device__ inline int k_tiles(int n_fft) { return (n_fft + CHAIN * BK - 1) / (CHAIN * BK) * CHAIN; }
__host__ __device__ inline int span_samples(int h, int n_fft) { return (TM - 1) * h + BK * k_tiles(n_fft); }
__host__ __device__ inline int span_floats(int h, int n_fft) {
  const int segs = (span_samples(h, n_fft) + h - 1) / h;
  return (segs * (h + PAD) + 3) / 4 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src to shared address dst; zfill: 4 zero bytes where !valid (src is not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

// tf32(x), round to nearest with ties away from zero, low 13 bits zero
// (the same arithmetic as csrc/flash_attention.cu and ops/attention_kernel.py:tf32_split)
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

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c (+)= a b as three TF32 products: the small ones hi.lo' and lo.hi', then
// the big one hi.hi', chained in the chain's fresh accumulators c
template <bool FIRST>
__device__ __forceinline__ void mma_3xtf32_chain(float (&c)[4], const FragA& a, const FragB& b) {
  if (FIRST)
    mma_tf32_first(c, a.hi, b.lo);
  else
    mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.hi);
}

// One k step (8 samples) of the DFT for a warp's MT x NTW tiles. A: the
// span's hi words at shared addresses a[i][0] (row g of m tile i) and
// a[i][1] (row g + 8), sample t of the k tile, plus `ka` bytes (the step's
// first sample), and its lo words `lo` bytes further; B: ring row t of the
// step at shared address b, the lane's column of n tile 0.
template <bool FIRST>
__device__ __forceinline__ void dft_step(const uint32_t (&a)[MT][2], uint32_t ka, uint32_t lo, uint32_t b,
                                         float (&c)[MT][NTW][4]) {
  FragA fa[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    fa[i].hi[0] = lds32(a[i][0] + ka);
    fa[i].hi[1] = lds32(a[i][1] + ka);
    fa[i].hi[2] = lds32(a[i][0] + ka + 16);
    fa[i].hi[3] = lds32(a[i][1] + ka + 16);
    fa[i].lo[0] = lds32(a[i][0] + lo + ka);
    fa[i].lo[1] = lds32(a[i][1] + lo + ka);
    fa[i].lo[2] = lds32(a[i][0] + lo + ka + 16);
    fa[i].lo[3] = lds32(a[i][1] + lo + ka + 16);
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    FragB fb;
    split(__uint_as_float(lds32(b + 32 * j)), fb.hi[0], fb.lo[0]);
    split(__uint_as_float(lds32(b + 32 * j + 16 * LDW)), fb.hi[1], fb.lo[1]);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_3xtf32_chain<FIRST>(c[i][j], fa[i], fb);
  }
}

// One k step (8 bins) of the projection for a warp's MT x PNT tiles: A from
// the power tile (split on the fly), B from the filterbank chunk, the warp's
// mels n0..
template <bool FIRST>
__device__ __forceinline__ void proj_step(const float* P, const float* F, int n0, int k0, int g, int t,
                                          float (&c)[MT][PNT][4]) {
  FragA a[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float* p = P + (16 * i + g) * LDP + k0 + t;
    split(p[0], a[i].hi[0], a[i].lo[0]);
    split(p[8 * LDP], a[i].hi[1], a[i].lo[1]);
    split(p[4], a[i].hi[2], a[i].lo[2]);
    split(p[8 * LDP + 4], a[i].hi[3], a[i].lo[3]);
  }
#pragma unroll
  for (int j = 0; j < PNT; ++j) {
    FragB b;
    const float* f = F + (k0 + t) * LDF + n0 + 8 * j + g;
    split(f[0], b.hi[0], b.lo[0]);
    split(f[4 * LDF], b.hi[1], b.lo[1]);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_3xtf32_chain<FIRST>(c[i][j], a[i], b);
  }
}

// The W copies of a thread: rows warp + WARPS q of each k tile, columns
// 32 j + lane of a ring row, j < 2 SLICE / 32. Column c of a row is bin
// 4 (c / 8) + c % 4 of the slice, re where (c / 4) % 2 == 0, else im.
struct WCopy {
  const float* src;  // row `warp` of k tile 0, the lane's bin of j = 0
  uint32_t dst;      // ring slot 0, row `warp`, column lane
  uint32_t cols;     // bit j: column 32 j + lane is a bin of the slice
  int row;           // floats a W row
};

// Stage k tile kt into the ring slot at byte offset `slot`. The columns
// outside the slice were zeroed once and are never written; rows past n_fft
// are zero-filled.
__device__ __forceinline__ void stage_w(const WCopy& w, int kt, uint32_t slot, int n_fft, int warp) {
  const float* s = w.src + static_cast<long long>(kt) * BK * w.row;
  const uint32_t d = w.dst + slot;
  if ((kt + 1) * BK <= n_fft) {
#pragma unroll
    for (int q = 0; q < BK / WARPS; ++q) {
#pragma unroll
      for (int j = 0; j < 2 * SLICE / 32; ++j)
        if (w.cols >> j & 1) cp_async4(d + 4 * WARPS * LDW * q + 128 * j, s + 16 * j);
      s += WARPS * w.row;
    }
  } else {
#pragma unroll
    for (int q = 0; q < BK / WARPS; ++q) {
      const bool ok = kt * BK + warp + WARPS * q < n_fft;
#pragma unroll
      for (int j = 0; j < 2 * SLICE / 32; ++j)
        if (w.cols >> j & 1) cp_async4_zfill(d + 4 * WARPS * LDW * q + 128 * j, ok ? s + 16 * j : w.src, ok);
      s += WARPS * w.row;
    }
  }
}

// Stage the fbanks rows of the block's slice, mels [c0, c0 + MCH), into F.
__device__ __forceinline__ void stage_fb(const Params& p, float* F, int bin0, int c0, int tid) {
  const int col = tid % MCH;
  const bool col_ok = c0 + col < p.n_mels;
  for (int bl = tid / MCH; bl < SLICE; bl += THREADS / MCH) {
    const bool ok = col_ok && bl < p.nb && bin0 + bl < p.n_freqs;
    const float* src = ok ? p.fb + static_cast<long long>(bin0 + bl) * p.n_mels + c0 + col : p.fb;
    cp_async4_zfill(smem_addr(F + bl * LDF + col), src, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2) fused_mel_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / csize;
  const int b = tile / p.tiles, f0 = (tile % p.tiles) * TM;
  const int n_rows = min(TM, p.n_frames - f0);
  const int bin0 = rank * p.nb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = p.h, hs = h + PAD;  // the frame stride, in the signal and in the skewed span

  // shared memory: the span's hi and lo arrays, p.spanf floats each; the ring
  const uint32_t span = smem_addr(smem);
  const uint32_t ring = span + 8 * p.spanf;
  float* ring_f = smem + 2 * p.spanf;

  // columns outside the slice stay zero in every stage
  for (int i = tid; i < RING / 4; i += THREADS) reinterpret_cast<float4*>(ring_f)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the tile's span, raw into the hi array: segment s (h samples) at s (h + PAD)
  {
    const float* src = p.frames + b * p.s_batch + static_cast<long long>(f0) * h;
    const int valid = (n_rows - 1) * h + p.n_fft;
    const int segs = (p.span + h - 1) / h;
    for (int s = warp; s < segs; s += WARPS)
      for (int x = lane; x < h; x += 32) {
        const int pos = s * h + x;
        const bool ok = pos < valid;
        cp_async4_zfill(span + 4 * (s * hs + x), ok ? src + pos : p.frames, ok);
      }
    cp_async_commit();
  }
  WCopy wc;
  {
    const int part = (lane / 4) % 2, bl = 4 * (lane / 8) + lane % 4;  // column lane: bin bl + 16 j
    wc.row = p.n_freqs;
    wc.src = (part ? p.w_im : p.w_re) + static_cast<long long>(warp) * wc.row + bin0 + bl;
    wc.dst = ring + 4 * (warp * LDW + lane);
    wc.cols = 0;
#pragma unroll
    for (int j = 0; j < 2 * SLICE / 32; ++j)
      if (bl + 16 * j < p.nb && bin0 + bl + 16 * j < p.n_freqs) wc.cols |= 1u << j;
  }
  __syncthreads();  // the zeroed columns before any copy lands beside them
  const int KT = k_tiles(p.n_fft);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    stage_w(wc, s, s * SLOT, p.n_fft, warp);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // the span has landed (the W stages may not have)
  __syncthreads();
  for (int i = tid; i < p.spanf / 4; i += THREADS) {
    const float4 x = reinterpret_cast<const float4*>(smem)[i];
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(smem)[i] = hi;
    reinterpret_cast<uint4*>(smem + p.spanf)[i] = lo;
  }

  // DFT: warp w owns every row of the tile and n tiles NTW w..
  uint32_t a[MT][2];  // span address of rows g and g + 8 of m tile i, sample t of the current k tile
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    a[i][0] = span + 4 * ((16 * i + g) * hs + t);
    a[i][1] = a[i][0] + 32 * hs;
  }
  // ring address of row t, the lane's column of n tile 0: bin g / 2 of the
  // group, re (g even) or im
  const uint32_t bcol = ring + 4 * (t * LDW + 8 * NTW * warp + 4 * (g & 1) + (g >> 1));
  float acc[MT][NTW][4], c[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // k tile kt: ring stage kt % STAGES; the span's samples 16 kt.. lie
  // 8 (16 kt + PAD floor(16 kt / h)) bytes in (h is a multiple of 16)
  const int tiles_a_row = h / BK;
  uint32_t slot = 0;
  for (int kt = 0; kt < KT; kt += CHAIN) {
#pragma unroll
    for (int u = 0; u < CHAIN; ++u) {
      cp_async_wait<STAGES - 2>();  // k tile kt + u has landed
      __syncthreads();              // ... for every thread; and the stage of k tile kt + u - 1 is free
      if (kt + u + STAGES - 1 < KT)
        stage_w(wc, kt + u + STAGES - 1, slot == 0 ? (STAGES - 1) * SLOT : slot - SLOT, p.n_fft, warp);
      cp_async_commit();
      if (u == 0)
        dft_step<true>(a, 0, 4 * p.spanf, bcol + slot, c);
      else
        dft_step<false>(a, 0, 4 * p.spanf, bcol + slot, c);
      dft_step<false>(a, 32, 4 * p.spanf, bcol + slot + 32 * LDW, c);
      slot = slot == (STAGES - 1) * SLOT ? 0 : slot + SLOT;
      const uint32_t step = 4 * (BK + ((kt + u + 1) % tiles_a_row == 0 ? PAD : 0));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a[i][0] += step;
        a[i][1] += step;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[i][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the span and the ring: they become P, F and Q

  float* P = smem;               // TM x LDP: power, rows of the tile, bins of the slice
  float* F = P + TM * LDP;       // SLICE x LDF: the slice's fbanks rows, a chunk of mels
  float* Q = F + SLICE * LDF;    // TM x LDQ: the block's partial mels
  stage_fb(p, F, bin0, 0, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int r = 16 * i + g, bl = 4 * (NTW * warp + j) + t;
      const float* d = acc[i][j];
      P[r * LDP + bl] = __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1]));
      P[(r + 8) * LDP + bl] = __fadd_rn(__fmul_rn(d[2], d[2]), __fmul_rn(d[3], d[3]));
    }

  // projection: warp w owns every row of the tile and mels 8 PNT w.. of a chunk
  const int nbk = p.nb / 8;
  const int rpr = (TM + csize - 1) / csize;  // rows of the tile a rank sums and stores
  for (int c0 = 0; c0 < p.n_mels; c0 += MCH) {
    if (c0 > 0) {
      stage_fb(p, F, bin0, c0, tid);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    float pacc[MT][PNT][4], pc[MT][PNT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < PNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[i][j][e] = 0.f;
    for (int ks = 0; ks < nbk; ks += 2 * CHAIN) {
      proj_step<true>(P, F, 8 * PNT * warp, 8 * ks, g, t, pc);
#pragma unroll
      for (int u = 1; u < 2 * CHAIN; ++u)
        if (ks + u < nbk) proj_step<false>(P, F, 8 * PNT * warp, 8 * (ks + u), g, t, pc);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < PNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[i][j][e] += pc[i][j][e];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < PNT; ++j) {
        float* q = Q + (16 * i + g) * LDQ + 8 * PNT * warp + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(q) = make_float2(pacc[i][j][0], pacc[i][j][1]);
        *reinterpret_cast<float2*>(q + 8 * LDQ) = make_float2(pacc[i][j][2], pacc[i][j][3]);
      }
    cluster.sync();  // every rank's partials are written

    const int mc = min(MCH, p.n_mels - c0);
    const int r_lo = rank * rpr, r_hi = min(n_rows, r_lo + rpr);
    for (int e = tid; e < (r_hi - r_lo) * mc; e += THREADS) {
      const int r = r_lo + e / mc, mel = e % mc;
      float v[MAX_CLUSTER];
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s)
        if (s < csize) v[s] = *cluster.map_shared_rank(Q + r * LDQ + mel, s);
      float sum = v[0];
#pragma unroll
      for (int s = 1; s < MAX_CLUSTER; ++s)  // in rank order: the same sum from run to run
        if (s < csize) sum += v[s];
      p.out[(static_cast<long long>(b) * p.n_frames + f0 + r) * p.n_mels + c0 + mel] = p.log_scale ? log1pf(sum) : sum;
    }
    cluster.sync();  // no rank reads this block's partials any more
  }
}

// bytes of dynamic shared memory for frame stride h and n_fft: the larger of
// the DFT phase (two span arrays and the ring) and the projection (P, F, Q)
long long smem_bytes(int h, int n_fft) {
  const long long dft = 2LL * span_floats(h, n_fft) + RING;
  return 4 * (dft > PROJ ? dft : PROJ);
}

// the largest dynamic shared memory the kernel has been allowed, per device
std::atomic<int> allowed[64];

}  // namespace

// Frames (batch, n_frames, n_fft) at strides (s_batch, s_frame, 1), n_fft ->
// n_freqs -> n_mels, with the plan of ops/mel_kernel.py:mel_plan: `cluster`
// slices (1 to 8) of nb bins (a multiple of 8, at most 80) that cover
// n_freqs, none empty. s_frame must be a multiple of 16 floats and the span
// of a tile's frames must fit in shared memory (fused_mel_smem_bytes).
extern "C" long long fused_mel_smem_bytes(long long s_frame, int n_fft) {
  if (s_frame < BK || s_frame % BK || s_frame > (1 << 20) || n_fft <= 0 || n_fft > (1 << 20)) return -1;
  return smem_bytes(static_cast<int>(s_frame), n_fft);
}

extern "C" int fused_mel_fwd(const void* frames, const void* w_re, const void* w_im, const void* fb, void* out,
                             int batch, int n_frames, long long s_batch, long long s_frame, int n_fft, int n_freqs,
                             int n_mels, int log_scale, int cluster, int nb, void* stream) {
  const long long smem = fused_mel_smem_bytes(s_frame, n_fft);
  if (batch <= 0 || n_frames <= 0 || n_freqs <= 0 || n_mels <= 0 || smem < 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > MAX_CLUSTER || nb < 8 || nb > SLICE || nb % 8 ||
      static_cast<long long>(cluster) * nb < n_freqs || static_cast<long long>(cluster - 1) * nb >= n_freqs)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_frames + TM - 1) / TM;
  const int h = static_cast<int>(s_frame);
  const Params p{static_cast<const float*>(frames), static_cast<const float*>(w_re), static_cast<const float*>(w_im),
                 static_cast<const float*>(fb),     static_cast<float*>(out),          s_batch,
                 h,                                 n_frames,                          tiles,
                 n_fft,                             n_freqs,                           n_mels,
                 nb,                                log_scale,                         span_samples(h, n_fft),
                 span_floats(h, n_fft)};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (allowed[device].load() < smem) {  // once per size and device, not per launch
    err = cudaFuncSetAttribute(fused_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_mel_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    int seen = allowed[device].load();
    while (seen < smem && !allowed[device].compare_exchange_weak(seen, static_cast<int>(smem))) {
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * batch * tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_mel_kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
