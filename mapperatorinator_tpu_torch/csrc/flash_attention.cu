// Flash attention for Hopper (sm_90a): the forward (kernel B) and the
// backward (kernel C).
//
// The forward replaces the Pallas kernel mapperatorinator_tpu/ops/
// attention_kernel.py: _attention_kernel, launched by _flash_forward behind
// flash_attention. The backward replaces _attention_bwd_kernel, launched by
// _bwd_call via _flash_backward; it is described below the forward.
//
// Forward.
// Computes out = softmax(q k^T * scale, masked) v with fp32 logits, softmax
// and accumulation. Masks come from indices: causal (k <= q), the band
// |q - k| <= window / 2, and a (B, S) key mask. A masked logit is
// finfo(float32).min, not -inf, exactly as in the reference: a row whose keys
// are all masked averages v over all S keys.
//
// Design: one block per (batch * head, 64-query tile). The block streams
// 64-key tiles of k and v through shared memory and keeps an online softmax
// (running max m, running sum l) per query row, so no (T, S) logits tile and
// no whole k/v row is ever resident: the TPU kernel kept a whole k/v row in
// VMEM, which does not fit 227 KB of shared memory at long S. q, k and v are
// read in their (B, T, H, D) layout through strides, so the fused qkv
// projection is consumed without transpose copies. Each of the 8 warps owns
// 8 query rows end to end (logits, softmax, P v), so only the k/v tile loads
// need a block barrier.
//
// What bounds it: at the v32 shape (T = S = 1024, H = 12, D = 64) the work is
// 4 * T * S * D flops per head, about 3.2 GFLOP per row of the batch, against
// a few MB of q/k/v traffic: compute bound. These kernels compute with fp32
// FMAs on the SIMT cores (67 TFLOP/s peak on an H100 SXM), not with tensor
// cores, so fp32 inputs keep full fp32 accuracy; the shared-memory operand
// reads (float4, conflict-free strides) are what limits the inner loops.
// They are the route of fp32; bf16 goes to the tensor-core (wgmma) kernels
// of flash_attention_sm90.cu (ops/attention_kernel.py, attention_route), and
// reaches these only when called directly, to time one beside the other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BLOCK_Q / WARPS;  // query rows per warp
constexpr int MAX_D = 128;
constexpr int DIMS = MAX_D / 32;       // output dims per lane
constexpr float MASKED = -3.4028234663852886e38f;  // finfo(float32).min

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_mask;  // (B, S) or null
  void* out;               // (B, T, H, D) contiguous
  float* lse;              // (B, H, T) row log-sum-exp, or null
  int B, T, S, H, D;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long m_sb;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int kstride = D + 4;  // pads k rows: lane-strided float4 reads stay conflict-free
  float* sQ = smem;                    // BLOCK_Q x D
  float* sK = sQ + BLOCK_Q * D;        // BLOCK_K x (D + 4)
  float* sV = sK + BLOCK_K * kstride;  // BLOCK_K x D
  float* sP = sV + BLOCK_K * D;        // BLOCK_Q x BLOCK_K

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint8_t* kv_mask = p.kv_mask ? p.kv_mask + b * p.m_sb : nullptr;
  const int half_window = p.window / 2;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int t = q0 + r;
    sQ[i] = t < p.T ? to_float(q[t * p.q_st + c]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DIMS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DIMS; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.S; k0 += BLOCK_K) {
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int s = k0 + r;
      const bool in = s < p.S;
      sK[r * kstride + c] = in ? to_float(k[s * p.k_ss + c]) : 0.f;
      sV[i] = in ? to_float(v[s * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // logits for this warp's rows at key columns lane and lane + 32
    float s0[ROWS], s1[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s0[r] = s1[r] = 0.f;
    for (int i = 0; i < D; i += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sK[lane * kstride + i]);
      const float4 kb = *reinterpret_cast<const float4*>(&sK[(lane + 32) * kstride + i]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&sQ[(warp * ROWS + r) * D + i]);
        s0[r] = fmaf(qv.x, ka.x, s0[r]);
        s0[r] = fmaf(qv.y, ka.y, s0[r]);
        s0[r] = fmaf(qv.z, ka.z, s0[r]);
        s0[r] = fmaf(qv.w, ka.w, s0[r]);
        s1[r] = fmaf(qv.x, kb.x, s1[r]);
        s1[r] = fmaf(qv.y, kb.y, s1[r]);
        s1[r] = fmaf(qv.z, kb.z, s1[r]);
        s1[r] = fmaf(qv.w, kb.w, s1[r]);
      }
    }

    const int ka_pos = k0 + lane, kb_pos = k0 + lane + 32;
    const bool a_in = ka_pos < p.S, b_in = kb_pos < p.S;
    const bool a_key = a_in && (kv_mask == nullptr || kv_mask[ka_pos]);
    const bool b_key = b_in && (kv_mask == nullptr || kv_mask[kb_pos]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int t = q0 + warp * ROWS + r;
      bool a_ok = a_key, b_ok = b_key;
      if (p.causal) {
        a_ok = a_ok && ka_pos <= t;
        b_ok = b_ok && kb_pos <= t;
      }
      if (p.window) {
        a_ok = a_ok && abs(t - ka_pos) <= half_window;
        b_ok = b_ok && abs(t - kb_pos) <= half_window;
      }
      // columns past S take no part; masked columns take finfo.min
      const float la = a_in ? (a_ok ? s0[r] * p.scale : MASKED) : -INFINITY;
      const float lb = b_in ? (b_ok ? s1[r] * p.scale : MASKED) : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(la, lb)));
      const float pa = expf(la - m_new), pb = expf(lb - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DIMS; ++c) acc[r][c] *= alpha;
      sP[(warp * ROWS + r) * BLOCK_K + lane] = pa;
      sP[(warp * ROWS + r) * BLOCK_K + lane + 32] = pb;
    }
    __syncwarp();

    for (int j = 0; j < BLOCK_K; j += 4) {
      float4 pr[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        pr[r] = *reinterpret_cast<const float4*>(&sP[(warp * ROWS + r) * BLOCK_K + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < DIMS; ++c) {
          const int d = c * 32 + lane;
          if (d < D) {
            const float vv = sV[(j + jj) * D + d];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              const float pv = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
              acc[r][c] = fmaf(pv, vv, acc[r][c]);
            }
          }
        }
      }
    }
    __syncwarp();
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = q0 + warp * ROWS + r;
    if (t >= p.T) continue;
    const float inv = 1.f / l[r];
    // a row whose keys are all masked has m = finfo.min and l = S, so its
    // lse rounds to finfo.min: the backward reads that as "no live key"
    if (p.lse != nullptr && lane == 0) p.lse[(static_cast<long long>(b) * p.H + h) * p.T + t] = m[r] + logf(l[r]);
    T* row = out + ((static_cast<long long>(b) * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DIMS; ++c) {
      const int d = c * 32 + lane;
      if (d < D) store(row + d, acc[r][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BLOCK_Q * p.D + BLOCK_K * (p.D + 4) + BLOCK_K * p.D + BLOCK_Q * BLOCK_K);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BLOCK_Q - 1) / BLOCK_Q, p.B * p.H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Backward.
//
// Given q, k, v, the forward's output O and its row log-sum-exp L, and dO:
//   P = exp(q k^T * scale - L) (recomputed, masked as in the forward),
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO * O),
//   dQ = dS K * scale, dK = dS^T Q * scale.
// dS is zero at masked entries: jnp.where(mask, logits, finfo.min) passes no
// gradient to a masked logit, so this is the exact gradient. (The Pallas
// kernel computes dS everywhere, which differs only in a row whose keys are
// all masked: there P is uniform, 1/S, and the exact dq and dk terms are 0.)
//
// Design: the TPU kernel keeps dk/dv in its output block across the
// sequential q-block grid axis. CUDA blocks run in no order, so here one block
// owns one (batch * head, 64-key tile) and loops over every 64-query tile
// itself, keeping its dk and dv rows in registers (fp32) to the end. dq gets
// contributions from every key tile, so each block adds its 64 x D partial
// with fp32 atomicAdd into a zeroed (B, T, H, D) fp32 buffer that the wrapper
// casts; the order of those sums changes from run to run. A small kernel
// first computes delta. No tile is skipped: a row whose keys are all masked
// has uniform P over all S keys, causal or not, and its dv term reaches
// every key.
//
// Inside a q tile each of the 8 warps owns 8 key rows (ROWS): it computes their
// logits and dP against the 64 queries (lanes own query columns), writes P
// and dS to shared memory, and accumulates its dk/dv rows (lanes own dims).
// Then, after a block barrier, each warp owns 8 query rows of dq over all 64
// keys and adds them to global memory.
//
// What bounds it: per (batch, head) it does 5 products of T x S x D (the
// recomputed logits, dP, dV, dK, dQ), 10 T S D flops, against q, k, v, O,
// dO traffic of a few MB: compute bound, on fp32 SIMT FMAs (67 TFLOP/s peak
// on an H100 SXM) as in the forward, plus T S D / 64 fp32 atomics for dq.
// The bf16 tensor-core backward is in flash_attention_sm90.cu; a dq pass
// without atomics is later work.

constexpr float ALL_MASKED = -1e38f;  // an lse below this: the row has no live key

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_mask;  // (B, S) or null
  const void* out;         // O, (B, T, H, D) contiguous
  const void* dout;        // dO, (B, T, H, D) strided
  const float* lse;        // (B, H, T)
  float* delta;            // (B, H, T), written by flash_bwd_delta_kernel
  float* dq;               // (B, T, H, D) contiguous fp32, zeroed, added to
  void* dk;                // (B, S, H, D) contiguous
  void* dv;                // (B, S, H, D) contiguous
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
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta_kernel(BwdParams p) {
  const long long row = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.T * p.H) return;
  const int h = static_cast<int>(row % p.H);
  const int t = static_cast<int>((row / p.H) % p.T);
  const int b = static_cast<int>(row / (static_cast<long long>(p.H) * p.T));
  const T* o = static_cast<const T*>(p.out) + row * p.D;
  const T* g = static_cast<const T*>(p.dout) + b * p.g_sb + t * p.g_st + h * p.g_sh;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(to_float(o[d]), to_float(g[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.T + t] = acc;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane4(const float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T, int NDIM>
__global__ void __launch_bounds__(THREADS) flash_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int pad = D + 4;  // q and dO rows are read lane-strided as float4: padded, conflict-free
  float* sK = smem;                       // BLOCK_K x D
  float* sV = sK + BLOCK_K * D;           // BLOCK_K x D
  float* sQ = sV + BLOCK_K * D;           // BLOCK_Q x (D + 4)
  float* sG = sQ + BLOCK_Q * pad;         // dO, BLOCK_Q x (D + 4)
  float* sP = sG + BLOCK_Q * pad;         // P, BLOCK_K x BLOCK_Q (key row, query column)
  float* sS = sP + BLOCK_K * BLOCK_Q;     // dS, BLOCK_K x BLOCK_Q
  float* sL = sS + BLOCK_K * BLOCK_Q;     // lse, BLOCK_Q
  float* sDelta = sL + BLOCK_Q;           // delta, BLOCK_Q

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * BLOCK_K;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* g = static_cast<const T*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const uint8_t* kv_mask = p.kv_mask ? p.kv_mask + b * p.m_sb : nullptr;
  const float* lse = p.lse + static_cast<long long>(blockIdx.y) * p.T;
  const float* delta = p.delta + static_cast<long long>(blockIdx.y) * p.T;
  const int half_window = p.window / 2;
  const float uniform = 1.f / p.S;  // P of every key in a row whose keys are all masked

  for (int i = tid; i < BLOCK_K * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int s = k0 + r;
    const bool in = s < p.S;
    sK[i] = in ? to_float(k[s * p.k_ss + c]) : 0.f;
    sV[i] = in ? to_float(v[s * p.v_ss + c]) : 0.f;
  }

  float dk[ROWS][NDIM], dv[ROWS][NDIM];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < NDIM; ++c) dk[r][c] = dv[r][c] = 0.f;
  }

  for (int q0 = 0; q0 < p.T; q0 += BLOCK_Q) {
    __syncthreads();  // every warp is done with the previous q tile
    for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int t = q0 + r;
      const bool in = t < p.T;
      sQ[r * pad + c] = in ? to_float(q[t * p.q_st + c]) : 0.f;
      sG[r * pad + c] = in ? to_float(g[t * p.g_st + c]) : 0.f;
    }
    if (tid < BLOCK_Q) {
      const int t = q0 + tid;
      sL[tid] = t < p.T ? lse[t] : 0.f;
      sDelta[tid] = t < p.T ? delta[t] : 0.f;
    }
    __syncthreads();

    // logits (s) and dP (e) of this warp's key rows at query columns lane and lane + 32
    float s0[ROWS], s1[ROWS], e0[ROWS], e1[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s0[r] = s1[r] = e0[r] = e1[r] = 0.f;
    for (int i = 0; i < D; i += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQ[lane * pad + i]);
      const float4 qb = *reinterpret_cast<const float4*>(&sQ[(lane + 32) * pad + i]);
      const float4 ga = *reinterpret_cast<const float4*>(&sG[lane * pad + i]);
      const float4 gb = *reinterpret_cast<const float4*>(&sG[(lane + 32) * pad + i]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 kr = *reinterpret_cast<const float4*>(&sK[(warp * ROWS + r) * D + i]);
        const float4 vr = *reinterpret_cast<const float4*>(&sV[(warp * ROWS + r) * D + i]);
        s0[r] = dot4(kr, qa, s0[r]);
        s1[r] = dot4(kr, qb, s1[r]);
        e0[r] = dot4(vr, ga, e0[r]);
        e1[r] = dot4(vr, gb, e1[r]);
      }
    }

    const int ta = q0 + lane, tb = q0 + lane + 32;
    const bool a_in = ta < p.T, b_in = tb < p.T;
    const float la = sL[lane], lb = sL[lane + 32];
    const float da = sDelta[lane], db = sDelta[lane + 32];
    const bool a_dead = la < ALL_MASKED, b_dead = lb < ALL_MASKED;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = warp * ROWS + r;
      const int s = k0 + j;
      const bool s_in = s < p.S;
      const bool key = s_in && (kv_mask == nullptr || kv_mask[s]);
      bool a_ok = key && a_in, b_ok = key && b_in;
      if (p.causal) {
        a_ok = a_ok && s <= ta;
        b_ok = b_ok && s <= tb;
      }
      if (p.window) {
        a_ok = a_ok && abs(ta - s) <= half_window;
        b_ok = b_ok && abs(tb - s) <= half_window;
      }
      // masked in-range entries: P is 0, or 1/S in a row with no live key
      float pa = 0.f, pb = 0.f;
      if (s_in && a_in) pa = a_ok ? expf(s0[r] * p.scale - la) : (a_dead ? uniform : 0.f);
      if (s_in && b_in) pb = b_ok ? expf(s1[r] * p.scale - lb) : (b_dead ? uniform : 0.f);
      sP[j * BLOCK_Q + lane] = pa;
      sP[j * BLOCK_Q + lane + 32] = pb;
      sS[j * BLOCK_Q + lane] = a_ok ? pa * (e0[r] - da) : 0.f;
      sS[j * BLOCK_Q + lane + 32] = b_ok ? pb * (e1[r] - db) : 0.f;
    }
    __syncwarp();

    // dv[j] += sum_i P[j, i] dO[i]; dk[j] += sum_i dS[j, i] q[i] (scaled at the end)
    for (int i = 0; i < BLOCK_Q; i += 4) {
      float4 pr[ROWS], sr[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        pr[r] = *reinterpret_cast<const float4*>(&sP[(warp * ROWS + r) * BLOCK_Q + i]);
        sr[r] = *reinterpret_cast<const float4*>(&sS[(warp * ROWS + r) * BLOCK_Q + i]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int c = 0; c < NDIM; ++c) {
          const int d = c * 32 + lane;
          if (d < D) {
            const float gv = sG[(i + ii) * pad + d];
            const float qv = sQ[(i + ii) * pad + d];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              dv[r][c] = fmaf(lane4(pr[r], ii), gv, dv[r][c]);
              dk[r][c] = fmaf(lane4(sr[r], ii), qv, dk[r][c]);
            }
          }
        }
      }
    }
    __syncthreads();  // every key row of dS is written

    // dq[i] += scale * sum_j dS[j, i] k[j] for this warp's 8 query rows
    float acc[ROWS][NDIM];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int c = 0; c < NDIM; ++c) acc[r][c] = 0.f;
    }
    for (int j = 0; j < BLOCK_K; ++j) {
      const float4 d0 = *reinterpret_cast<const float4*>(&sS[j * BLOCK_Q + warp * ROWS]);
      const float4 d1 = *reinterpret_cast<const float4*>(&sS[j * BLOCK_Q + warp * ROWS + 4]);
#pragma unroll
      for (int c = 0; c < NDIM; ++c) {
        const int d = c * 32 + lane;
        const float kv = d < D ? sK[j * D + d] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][c] = fmaf(lane4(r < 4 ? d0 : d1, r & 3), kv, acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int t = q0 + warp * ROWS + r;
      if (t >= p.T) continue;
      float* row = p.dq + ((static_cast<long long>(b) * p.T + t) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < NDIM; ++c) {
        const int d = c * 32 + lane;
        if (d < D) atomicAdd(row + d, acc[r][c] * p.scale);
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = k0 + warp * ROWS + r;
    if (s >= p.S) continue;
    const long long base = ((static_cast<long long>(b) * p.S + s) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < NDIM; ++c) {
      const int d = c * 32 + lane;
      if (d < D) {
        store(dk_out + base + d, dk[r][c] * p.scale);
        store(dv_out + base + d, dv[r][c]);
      }
    }
  }
}

template <typename T, int NDIM>
cudaError_t launch_bwd_dims(const BwdParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.T * p.H;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (2 * BLOCK_K * p.D + 2 * BLOCK_Q * (p.D + 4) + 2 * BLOCK_K * BLOCK_Q +
                                       2 * BLOCK_Q);
  err = cudaFuncSetAttribute(flash_bwd_kernel<T, NDIM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BLOCK_K - 1) / BLOCK_K, p.B * p.H);
  flash_bwd_kernel<T, NDIM><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  return p.D <= 64 ? launch_bwd_dims<T, 2>(p, stream) : launch_bwd_dims<T, 4>(p, stream);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                                   void* out, void* lse, int B, int T, int S, int H, int D, long long q_sb,
                                   long long q_st, long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                   long long m_sb, int causal, int window, float scale, int is_bf16,
                                   void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    static_cast<const uint8_t*>(kv_mask),
                 out,  static_cast<float*>(lse),
                 B,    T,    S,    H,    D,
                 q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, m_sb,
                 causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

// dq must be zeroed by the caller; delta is scratch of B * H * T floats.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* kv_mask,
                                   const void* out, const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int T, int S, int H, int D, long long q_sb,
                                   long long q_st, long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                   long long g_sb, long long g_st, long long g_sh, long long m_sb, int causal,
                                   int window, float scale, int is_bf16, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const BwdParams p{q,    k,    v,    static_cast<const uint8_t*>(kv_mask),
                    out,  dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                    static_cast<float*>(dq), dk, dv,
                    B,    T,    S,    H,    D,
                    q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                    v_sb, v_ss, v_sh, g_sb, g_st, g_sh, m_sb,
                    causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bwd<__nv_bfloat16>(p, s) : launch_bwd<float>(p, s));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
