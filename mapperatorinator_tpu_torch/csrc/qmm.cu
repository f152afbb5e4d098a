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
// Two kernels, each behind its own entry point (qmm_gemv, qmm_tc); the
// wrapper, ops/qmm_kernel.py:qmm_kernel, picks one by the row count:
//
// * rows <= 4 (a decode step: batch 1, or 2 with CFG): a GEMV with K split
//   across the blocks of a thread-block cluster (qmm_gemv_cluster_kernel).
//   What bounds it: bytes, and at these sizes the latency of one pass over
//   them. It reads the K x N int8 weight once; with x, the scales and the
//   output, at 3.35 TB/s, a v32 decode step's products (rows 1) need
//     qkv                    768 x 2304   1.79 MB   0.53 us
//     self out, cross q, out 768 x 768    0.60 MB   0.18 us
//     fc1                    768 x 3072   2.39 MB   0.71 us
//     fc2                    3072 x 768   2.38 MB   0.71 us
//   and a step makes 72 such calls (12 layers x 6), 99 MB, twice the 50 MB
//   L2, so each call finds its weight cold in device memory. Such a call is
//   one round trip to device memory, not a stream: to approach the bound the
//   whole weight has to be requested at once, from enough SMs.
//   Design: ops/qmm_kernel.py:gemv_plan picks a column tile bn (128, 64 or
//   32: the widest that still gives every SM a block) and splits K into up
//   to 8 slices of at least 64 rows, one a block of a cluster: 144 to 192
//   blocks of 128 threads at the decode shapes. A thread owns 16 columns of
//   its block's tile, one 16-byte load a weight row, neighbouring threads
//   on neighbouring chunks of a row, and rows k, k + tk, ... of the slice;
//   it starts GV_BATCH (8) such loads before it uses the first, so at the
//   decode shapes a block requests its whole slab (6 to 12 KB) at once.
//   Kept over a TMA bulk copy of the slab: its rows lie N bytes apart, so a
//   1-D bulk copy moves one 32- to 128-byte row at a time, and a 2-D tensor
//   map needs a descriptor for each weight (cuTensorMapEncodeTiled); loads in
//   a batch put the same bytes in flight with no pass through shared memory.
//   While they fly, the block's K slice of x goes to shared memory once, as
//   fp32 (read as a broadcast), and rank 0 fetches the scales it will need.
//   The upcast is int8x4_to_float: exact, no int-to-float unit. Each block
//   reduces its sums over its warps (shuffles, then shared memory); the
//   other ranks then write theirs into rank 0's shared memory through
//   distributed shared memory, by st.async, whose bytes complete on an
//   mbarrier of rank 0's, so rank 0 waits for the data itself and no block
//   waits for another at a second cluster barrier. Rank 0 adds the blocks'
//   sums in rank order, scales in fp32, rounds once to x's dtype and stores
//   16-byte vectors. No atomics and one launch: the same bits from run to
//   run.
//   Tried on the H100 and not kept (chip_smoke.py times the three tiles at
//   each decode shape): 256 threads a block, and 4 loads in flight a thread
//   instead of 8 (neither better across the decode shapes); rank 0 reading
//   the other blocks' sums instead of receiving them, fetching the scales
//   only at the end, and plain stores into rank 0's memory followed by a
//   second cluster barrier (arrive.release, wait.acquire) in place of
//   st.async (each slower); each warp sending its sums
//   straight to rank 0 after a shuffle reduce-scatter (no block reduction,
//   but four times the sums for rank 0 to add, and the sums array went to
//   the local stack: slower); a 256-column tile; clusters of 2 or 4. Tiles
//   of 64 or 128 columns, with fewer than 132 blocks, were faster at
//   768 x 768 than the plan's 32: the plan keeps a block on every SM all
//   the same.
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
// K needs no alignment (K = 200 works: the GEMV stages x element by
// element, and the tensor-core path does so where K is not a whole number of
// 16 bytes of x); N must be a
// multiple of 16 and the weight 16-byte aligned, which the Python wrapper
// checks.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// The four int8 values of a word as fp32, exactly and without the
// quarter-rate int-to-float unit: byte b of q ^ 0x80808080 is q_b + 128, and
// as the low mantissa byte of 2^23 it gives the float 2^23 + 128 + q_b.
__device__ __forceinline__ void int8x4_to_float(uint32_t q, float (&f)[4]) {
  const uint32_t u = q ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes of adjacent outputs, rounded to T: 4 fp32 or 8 bf16
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 packed;
  packed.x = bf16_pair(v[0], v[1]);
  packed.y = bf16_pair(v[2], v[3]);
  packed.z = bf16_pair(v[4], v[5]);
  packed.w = bf16_pair(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = packed;
}

// ---- GEMV: rows <= 4, K split across a thread-block cluster ----------------

constexpr int GV_THREADS = 128;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_BATCH = 8;        // 16-byte weight loads a thread starts before it uses the first
constexpr int GV_MAX_CLUSTER = 8;  // the portable cluster size

// A thread's next GV_BATCH weight chunks, rows k, k + tk, ... of its K slice
// (those at or past k1 are not read), 16 int8 columns from n0 each.
__device__ __forceinline__ void load_batch(int4 (&q)[GV_BATCH], const int8_t* __restrict__ w, int k, int k1, int tk,
                                           int N, int n0) {
#pragma unroll
  for (int u = 0; u < GV_BATCH; ++u) {
    const int kk = k + u * tk;
    q[u] = kk < k1 ? __ldg(reinterpret_cast<const int4*>(w + static_cast<long long>(kk) * N + n0))
                   : make_int4(0, 0, 0, 0);
  }
}

// The cluster barrier in two halves (every thread of every block arrives,
// then waits for the others' arrivals; a thread that has exited counts as
// arrived). arrive.relaxed orders nothing but the mbarrier initialization
// fenced before it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// rank 0's address in the cluster's shared memory window of a shared-memory
// address of this block
__device__ __forceinline__ uint32_t rank0_addr(uint32_t local) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(remote) : "r"(local));
  return remote;
}

// Grid: cluster x ceil(N / bn) blocks, a cluster of `cluster` blocks a
// column tile. Block rank r of a cluster sums rows [r ks, min(K, (r + 1) ks))
// of the tile's bn columns. The other ranks send their sums into rank 0's
// shared memory by st.async, each store counting its bytes on an mbarrier of
// rank 0's; once they have all landed, rank 0 adds the ranks' sums in rank
// order, scales and stores. Dynamic shared memory, fp32: the K slice of x
// (R x ks), the warps' sums (GV_WARPS x R x bn), and in rank 0 every rank's
// sums (cluster x R x bn).
template <typename T, int R>
__global__ void __launch_bounds__(GV_THREADS)
    qmm_gemv_cluster_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                            T* __restrict__ out, int K, int N, int bn, int ks) {
  extern __shared__ __align__(16) float gv_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nt = (blockIdx.x / static_cast<int>(cluster.num_blocks())) * bn;  // the tile's first column
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tn = bn / 16, tk = GV_THREADS / tn;  // threads along N (16 columns each) and along K
  const int tx = tid % tn, ty = tid / tn;
  const int n0 = nt + 16 * tx;
  const int k0 = rank * ks, k1 = min(K, k0 + ks);
  float* xs = gv_smem;
  float* red = xs + R * ks;
  float* sums = red + GV_WARPS * R * bn;
  // N is a multiple of 16: a thread's 16 columns are all in or all out
  const bool active = n0 < N;
  // rank 0's thread tid stores outputs e .. e + V - 1 of the tile's R x bn
  // (row e / bn), 16 bytes; V divides 16, so they are all in or all out of N
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int e = tid * V, ne = nt + e % bn;
  const bool stores = rank == 0 && e < R * bn && ne < N;

  // rank 0's mbarrier: one arrival (its own, below) and the bytes of the
  // other ranks' sums, which their stores count off as they land
  __shared__ __align__(8) uint64_t gv_bar;
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(&gv_bar));
  if (rank == 0 && tid == 0) {
    const uint32_t bytes = static_cast<uint32_t>((static_cast<int>(cluster.num_blocks()) - 1) * R * bn * 4);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  }
  cluster_arrive_relaxed();  // this block has started: the others may write its shared memory after their wait

  // the first batch of weights and the scales are in flight while x is staged
  int4 q[GV_BATCH];
  int k = k0 + ty;
  load_batch(q, w, k, active ? k1 : k0, tk, N, n0);
  float sc[V];
  if (stores) {
#pragma unroll
    for (int c = 0; c < V; ++c) sc[c] = __ldg(scale + ne + c);
  }
  for (int i = tid; i < R * ks; i += GV_THREADS) {
    const int r = i / ks, kk = k0 + i % ks;
    xs[i] = kk < k1 ? to_float(x[static_cast<long long>(r) * K + kk]) : 0.f;
  }
  __syncthreads();

  float acc[R][16];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  if (active) {
    for (;;) {
#pragma unroll
      for (int u = 0; u < GV_BATCH; ++u) {
        const int kk = k + u * tk;
        if (kk >= k1) break;
        float xr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) xr[r] = xs[r * ks + kk - k0];  // a broadcast to the threads of one row
        const uint32_t words[4] = {static_cast<uint32_t>(q[u].x), static_cast<uint32_t>(q[u].y),
                                   static_cast<uint32_t>(q[u].z), static_cast<uint32_t>(q[u].w)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float f[4];
          int8x4_to_float(words[c], f);
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r][4 * c + b] = fmaf(xr[r], f[b], acc[r][4 * c + b]);
        }
      }
      k += GV_BATCH * tk;
      if (k >= k1) break;
      load_batch(q, w, k, k1, tk, N, n0);
    }
  }

  // lane = (ty % (32 / tn)) * tn + tx: the threads of a warp that share
  // columns differ in lane bits log2(tn) .. 4
  for (int off = 16; off >= tn; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
  if (lane < tn) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[(warp * R + r) * bn + 16 * lane + j] = acc[r][j];
  }
  __syncthreads();

  cluster_wait();  // every block of the cluster has started, and rank 0's mbarrier is ready
  if (rank != 0) {
    // the block's sums, 16 bytes a store, into rank 0's slot for this rank; the
    // values travel in the store, so the block may leave once it has started it
    const uint32_t to = rank0_addr(static_cast<uint32_t>(__cvta_generic_to_shared(sums + rank * R * bn)));
    const uint32_t rbar = rank0_addr(bar);
    for (int i = 4 * tid; i < R * bn; i += 4 * GV_THREADS) {
      float s4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s4[c] = red[i + c];
#pragma unroll
        for (int wi = 1; wi < GV_WARPS; ++wi) s4[c] += red[wi * R * bn + i + c];
      }
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
                   ::"r"(to + 4u * i), "f"(s4[0]), "f"(s4[1]), "f"(s4[2]), "f"(s4[3]), "r"(rbar)
                   : "memory");
    }
    return;
  }
  for (int i = tid; i < R * bn; i += GV_THREADS) {
    float s = red[i];
#pragma unroll
    for (int wi = 1; wi < GV_WARPS; ++wi) s += red[wi * R * bn + i];
    sums[i] = s;
  }
  // wait for the other ranks' sums; a count of bytes that never completes
  // traps (the next synchronization reports the error) rather than hanging
  // the card
  for (uint32_t done = 0, spin = 0; !done; ++spin) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(bar)
                 : "memory");
    if (spin == (1u << 24)) __trap();
  }
  __syncthreads();  // ... and rank 0's own, from every thread

  if (stores) {
    const int csize = static_cast<int>(cluster.num_blocks());
    float v[V];
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = sums[e + c];
    for (int src = 1; src < csize; ++src)  // in rank order: the same sum from run to run
#pragma unroll
      for (int c = 0; c < V; ++c) v[c] += sums[src * R * bn + e + c];
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] *= sc[c];
    store16(out + static_cast<long long>(e / bn) * N + ne, v);
  }
}

// Raise ``kernel``'s dynamic shared memory limit to ``smem`` bytes on the
// current device, once per size and device rather than per launch:
// ``allowed`` holds the largest size granted so far, per device. A launch
// inside a CUDA-graph capture then makes no call but the launch itself,
// once an eager launch of the same size has run.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<int>* allowed, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // the default: nothing to ask for
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (allowed[device].load() >= static_cast<int>(smem)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int seen = allowed[device].load();
  while (seen < static_cast<int>(smem) && !allowed[device].compare_exchange_weak(seen, static_cast<int>(smem))) {
  }
  return cudaSuccess;
}

template <typename T, int R>
cudaError_t launch_gemv(const void* x, const void* w, const void* scale, void* out, int K, int N, int bn, int cluster,
                        int ks, cudaStream_t stream) {
  static std::atomic<int> allowed[64];  // one per instantiation: each is its own kernel
  const size_t smem = sizeof(float) * (static_cast<size_t>(R) * ks + (GV_WARPS + cluster) * R * bn);
  const cudaError_t set = allow_smem(qmm_gemv_cluster_kernel<T, R>, allowed, smem);
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((N + bn - 1) / bn));
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qmm_gemv_cluster_kernel<T, R>, static_cast<const T*>(x),
                                             static_cast<const int8_t*>(w), static_cast<const float*>(scale),
                                             static_cast<T*>(out), K, N, bn, ks);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemv_rows(const void* x, const void* w, const void* scale, void* out, int rows, int K, int N,
                             int bn, int cluster, int ks, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_gemv<T, 1>(x, w, scale, out, K, N, bn, cluster, ks, stream);
    case 2: return launch_gemv<T, 2>(x, w, scale, out, K, N, bn, cluster, ks, stream);
    case 3: return launch_gemv<T, 3>(x, w, scale, out, K, N, bn, cluster, ks, stream);
    default: return launch_gemv<T, 4>(x, w, scale, out, K, N, bn, cluster, ks, stream);
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
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) { store16(p, v); }

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
  static std::atomic<int> allowed[64];
  constexpr int smem = TC_SMEM<T>;
  const cudaError_t err = allow_smem(qmm_tc_kernel<T, VEC>, allowed, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (rows + TC_BM - 1) / TC_BM);
  qmm_tc_kernel<T, VEC><<<grid, TC_THREADS, smem, stream>>>(x, w, scale, out, rows, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_vec(const void* x, const void* w, const void* scale, void* out, int rows, int K, int N,
                          cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  const bool vec = K % (16 / static_cast<int>(sizeof(T))) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  return vec ? launch_tc<T, true>(xp, wp, sp, op, rows, K, N, stream)
             : launch_tc<T, false>(xp, wp, sp, op, rows, K, N, stream);
}

}  // namespace

// The GEMV path, 1 to 4 rows, with its plan (ops/qmm_kernel.py:gemv_plan):
// column tiles of bn (32, 64 or 128), a cluster of `cluster` blocks (1 to
// 8) a tile, K slices of ks rows (a multiple of 4) that cover K, none empty.
extern "C" int qmm_gemv(const void* x, const void* w, const void* scale, void* out, int rows, int K, int N, int bf16,
                        int bn, int cluster, int ks, void* stream) {
  if (rows < 1 || rows > 4 || K <= 0 || N <= 0 || N % 16) return (int)cudaErrorInvalidValue;
  if ((bn != 32 && bn != 64 && bn != 128) || cluster < 1 || cluster > GV_MAX_CLUSTER ||
      ks < 1 || ks % 4 || static_cast<long long>(cluster) * ks < K || static_cast<long long>(cluster - 1) * ks >= K)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_gemv_rows<__nv_bfloat16>(x, w, scale, out, rows, K, N, bn, cluster, ks, s)
                    : launch_gemv_rows<float>(x, w, scale, out, rows, K, N, bn, cluster, ks, s));
}

// The tensor-core path, any row count (the wrapper sends it more than 4).
extern "C" int qmm_tc(const void* x, const void* w, const void* scale, void* out, int rows, int K, int N, int bf16,
                      void* stream) {
  if (rows <= 0 || K <= 0 || N <= 0 || N % 16) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_tc_vec<__nv_bfloat16>(x, w, scale, out, rows, K, N, s)
                    : launch_tc_vec<float>(x, w, scale, out, rows, K, N, s));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
