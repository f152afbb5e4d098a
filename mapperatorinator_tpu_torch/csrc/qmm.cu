// Int8 weight-only matrix product for Hopper (sm_90a): kernel D.
//
// Replaces the Pallas kernel mapperatorinator_tpu/ops/qmm_kernel.py:
// _qmm_kernel, launched by qmm. Computes
//   out[r, n] = (sum_k x[r, k] * float(wq[k, n])) * scale[n]
// with x (rows, K) fp32 or bf16, wq (K, N) int8 in row-major (the JAX
// QDense layout, N contiguous), scale (N,) fp32: the int8 weight is upcast
// in registers or shared memory after it crosses device memory, the sum is
// fp32, the per-column scale is applied once in fp32, and the output is
// rounded to x's dtype.
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
// * more rows (the encoder's 1024-row windows, the prefill): a tiled SIMT
//   GEMM. A block computes a 64 x 64 output tile, 4 x 4 outputs a thread,
//   staging a 64 x 16 tile of x (as fp32) and a 16 x 64 tile of the weight
//   (upcast from int8) in shared memory for each step of 16 along K.
//   What bounds it: at 1024 x 768 x 3072 it is 4.8 GFLOP against 2.4 MB of
//   weight and a few MB of activations, compute bound; on fp32 SIMT FMAs its
//   floor is 0.07 ms, against 0.005 ms for bf16 on the tensor cores. A
//   `wgmma` kernel with the int8 tile upcast in shared memory is later work.
//
// K needs no alignment (K = 200 works); N must be a multiple of 16 and the
// weight 16-byte aligned, which the Python wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- GEMM: more rows ------------------------------------------------------

constexpr int GM_BM = 64, GM_BN = 64, GM_BK = 16;
constexpr int GM_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(GM_THREADS)
    qmm_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                    T* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[GM_BK][GM_BM + 4];  // x tile, k-major
  __shared__ __align__(16) float ws[GM_BK][GM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // x: row tid / 4, columns (tid % 4) * 4 .. + 3 of the tile; w: row tid / 16,
  // columns (tid % 16) * 4 .. + 3, one 4-byte load
  const int xm = tid / 4, xk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 4;

  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    const int gm = m0 + xm;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + xk + j;
      xs[xk + j][xm] = (gm < M && gk < K) ? to_float(x[static_cast<long long>(gm) * K + gk]) : 0.f;
    }
    float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
    const int gk = k0 + wk, gn = n0 + wn;
    if (gk < K && gn < N) {  // N is a multiple of 16: the 4 columns are all in or all out
      const char4 q = *reinterpret_cast<const char4*>(w + static_cast<long long>(gk) * N + gn);
      wv = make_float4(q.x, q.y, q.z, q.w);
    }
    *reinterpret_cast<float4*>(&ws[wk][wn]) = wv;
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[static_cast<long long>(m) * N + n] = from_float<T>(acc[i][j] * scale[n]);
    }
  }
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
      const dim3 grid((N + GM_BN - 1) / GM_BN, (rows + GM_BM - 1) / GM_BM);
      qmm_gemm_kernel<T><<<grid, GM_THREADS, 0, stream>>>(xp, wp, sp, op, rows, K, N);
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
