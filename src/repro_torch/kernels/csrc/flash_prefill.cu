// Kernel A: causal flash-attention prefill with grouped KV heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), which the JAX package's ACCEL prompt prefill reaches
// through kernels/ops.py::flash_attention.  Same function: for each
// (batch, query head) softmax(q k^T / sqrt(hd)) v with query row i seeing
// keys j <= i + (T - S), online softmax in float32, output in q's dtype.
//
// Design.  One block per (query tile of 64 rows, query head, batch row),
// four warps of 16 query rows each.  The TPU kernel carried m/l/acc in VMEM
// scratch across a sequential third grid axis; here blocks run in no order,
// so the KV walk is a loop inside the block: each 64-key tile of K and V is
// staged in shared memory (converted to float32 once), every lane scores two
// keys for its warp's 16 rows with FMAs, the row max and sum reduce with warp
// shuffles, the probabilities go through shared memory, and each lane
// accumulates hd/32 output columns of its warp's rows in registers.  Tiles
// past the tile's last visible key are never loaded (causal skip).  GQA reads
// KV head kv_map[h] straight from the (B, T, KV, hd) cache: no head-expanded
// copy.  A ragged S (the serve engine's power-of-two prompt buckets are not
// tile multiples) is masked at the edge tile.  The scale uses the real hd.
//
// Bound on an H100.  At the serve path's shapes (S <= 1024, hd = 64) the
// kernel does 4*S*S/2*hd*H causal FLOPs per batch row over 2*S*hd*(H+2*KV)
// bytes, well above the card's bytes-per-FLOP ridge, so it is bound by
// operations.  This first version multiplies on the CUDA cores in float32,
// not on the tensor cores; wgmma tiles fed by TMA are the next step.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per staged tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;     // query rows per warp
constexpr int KPL = BK / 32;        // keys per lane

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     const int* __restrict__ kv_map, int S, int Tk, int H,
                     int KV, float scale) {
  constexpr int DPL = HD / 32;      // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                         // BQ x (HD + 1)
  float* Ks = Qs + BQ * (HD + 1);           // BK x (HD + 1)
  float* Vs = Ks + BK * (HD + 1);           // BK x HD
  float* Ps = Vs + BK * HD;                 // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = kv_map[h];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int off = Tk - S;                   // causal offset

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * (HD + 1) + d] =
        s < S ? to_f32(q[((size_t)(b * S + s) * H + h) * HD + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = min(Tk, q_last + off + 1);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                // Qs staged; last tile fully consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      const size_t g = ((size_t)(b * Tk + t) * KV + kvh) * HD + d;
      Ks[r * (HD + 1) + d] = t < Tk ? to_f32(k[g]) : 0.f;
      Vs[r * HD + d] = t < Tk ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPW][KPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float kk[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) kk[j] = Ks[(lane + 32 * j) * (HD + 1) + d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float qq = Qs[(warp * RPW + r) * (HD + 1) + d];
#pragma unroll
        for (int j = 0; j < KPL; ++j) s[r][j] = fmaf(qq, kk[j], s[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qi = q0 + warp * RPW + r;
      float mx = NEG_INF;
      bool valid[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int t = k0 + lane + 32 * j;
        valid[j] = t < Tk && t <= qi + off;
        s[r][j] = valid[j] ? s[r][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = valid[j] ? expf(s[r][j] - m_new) : 0.f;
        Ps[(warp * RPW + r) * (BK + 1) + lane + 32 * j] = p;
        ps += p;
      }
      l[r] = l[r] * corr + warp_sum(ps);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
    }
    __syncwarp();

    const int t_n = min(BK, Tk - k0);
    for (int t = 0; t < t_n; ++t) {
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = Vs[t * HD + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = Ps[(warp * RPW + r) * (BK + 1) + t];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    if (qi < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        o[((size_t)(b * S + qi) * H + h) * HD + lane + 32 * e] =
            from_f32<T>(acc[r][e] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* kv_map, int B, int S, int Tk, int H, int KV,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_prefill_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_map, S, Tk, H, KV,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, const int* kv_map, int B, int S, int Tk, int H,
                      int KV, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, kv_map, B, S, Tk, H, KV, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Built for
// head_dim 64 (smollm-135m); any other returns cudaErrorInvalidValue.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* o,
                                    const void* kv_map, int B, int S, int Tk,
                                    int H, int KV, int hd, int dtype,
                                    float scale, void* stream) {
  if (B < 1 || S < 1 || Tk < S || H < 1 || KV < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int* km = static_cast<const int*>(kv_map);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, k, v, o, km, B, S, Tk, H, KV, scale, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, km, B, S, Tk, H, KV, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
