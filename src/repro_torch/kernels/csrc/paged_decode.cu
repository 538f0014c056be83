// Kernel B: one-token GQA decode over a block-table KV pool.
//
// Replaces the TPU kernel repro/kernels/gqa_decode.py::paged_gqa_decode
// (_paged_kernel + _paged_accumulate), which every ACCEL decode step of the
// JAX serve engine reaches (paged pools directly, dense caches through an
// identity block table).  Same function: the G query heads that share a kv
// head attend pool positions [0, len[b]) of their row, read through the
// row's block table, then the current token's k_new/v_new is folded in
// last; a row with len = 0 returns v_new.
//
// Design.  One block per (kv head, batch row), four warps.  The block loads
// its own length and block-table entries (the TPU kernel had them
// scalar-prefetched ahead of the grid).  Warps take interleaved 32-position
// chunks of the row; each lane scores one position for all G query rows
// (G = 3 here, below any tensor-core tile, so the rows stay in registers
// and use FMAs), the chunk's softmax statistics reduce with warp shuffles,
// and each lane accumulates hd/32 output columns.  The four warps' partial
// (m, l, acc) merge in shared memory, then the current token folds in.
// The pool is read in its own dtype and converted in registers: a float32
// query over a bfloat16 pool gets the same values as the JAX paths' cast of
// the whole pool layer to float32, without that per-layer copy.
//
// Bound on an H100: bytes.  Each step reads every live KV position once
// (2 * len * hd * sizeof(pool) per kv head) and does 4 * G * hd FLOPs per
// position, far below the card's ops-per-byte ridge.  This first version
// issues one scalar load per element and runs only B * KV blocks; wider
// loads and splitting a row over more blocks are the next steps.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int GMAX = 8;             // largest GQA group the kernel takes

template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const TQ* __restrict__ kn,
                    const TQ* __restrict__ vn, const int* __restrict__ tables,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int KV, int G, int BS, int NBT, float scale) {
  constexpr int DPL = HD / 32;
  __shared__ float qs[GMAX][HD];
  __shared__ float wm[WARPS][GMAX];
  __shared__ float wl[WARPS][GMAX];
  __shared__ float wacc[WARPS][GMAX][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t head = (size_t)b * KV + kvh;

  for (int i = tid; i < G * HD; i += THREADS)
    qs[i / HD][i % HD] = to_f32(q[head * G * HD + i]);
  __syncthreads();

  const int len = lengths[b];
  const int* table = tables + (size_t)b * NBT;
  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  for (int c0 = warp * 32; c0 < len; c0 += WARPS * 32) {
    const int p = c0 + lane;
    const bool valid = p < len;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (valid) {
      const size_t base =
          (((size_t)table[p / BS] * BS + p % BS) * KV + kvh) * HD;
      for (int d = 0; d < HD; ++d) {
        const float kk = to_f32(kp[base + d]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) s[g] = fmaf(qs[g][d], kk, s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float sg = valid ? s[g] * scale : NEG_INF;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float corr = expf(m[g] - m_new);
        const float pg = valid ? expf(sg - m_new) : 0.f;
        l[g] = l[g] * corr + warp_sum(pg);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
        s[g] = pg;
      }
    }
    const int n = min(32, len - c0);
    for (int j = 0; j < n; ++j) {
      const int pj = c0 + j;
      const size_t base =
          (((size_t)table[pj / BS] * BS + pj % BS) * KV + kvh) * HD;
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = to_f32(vp[base + lane + 32 * e]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pg = __shfl_sync(FULL_MASK, s[g], j);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pg, vv[e], acc[g][e]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        wm[warp][g] = m[g];
        wl[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) wacc[warp][g][lane + 32 * e] = acc[g][e];
    }
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(wm[w][g] - M);
      L += wl[w][g] * c;
      A += wacc[w][g][d] * c;
    }
    float sc = 0.f;
    for (int dd = 0; dd < HD; ++dd) sc = fmaf(qs[g][dd], to_f32(kn[head * HD + dd]), sc);
    sc *= scale;
    const float M2 = fmaxf(M, sc);
    const float corr = expf(M - M2);
    const float pc = expf(sc - M2);
    const float L2 = L * corr + pc;
    out[head * G * HD + i] = from_f32<TQ>(
        (A * corr + pc * to_f32(vn[head * HD + d])) / fmaxf(L2, 1e-20f));
  }
}

template <typename TQ, typename TP>
cudaError_t launch_hd(int hd, const void* q, const void* kp, const void* vp,
                      const void* kn, const void* vn, const int* tables,
                      const int* lengths, void* out, int B, int KV, int G,
                      int BS, int NBT, float scale, cudaStream_t stream) {
  dim3 grid(KV, B);
#define REPRO_TORCH_LAUNCH(HD)                                              \
  paged_decode_kernel<TQ, TP, HD><<<grid, THREADS, 0, stream>>>(            \
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),                \
      static_cast<const TP*>(vp), static_cast<const TQ*>(kn),               \
      static_cast<const TQ*>(vn), tables, lengths, static_cast<TQ*>(out),   \
      KV, G, BS, NBT, scale)
  switch (hd) {
    case 64: REPRO_TORCH_LAUNCH(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_TORCH_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// q_dtype / pool_dtype: 0 = float32, 1 = bfloat16.  q, k_new, v_new and
// out share q_dtype; the two pools share pool_dtype.  Built for the pairs
// the serve path sends (float32 over float32, float32 over bfloat16,
// bfloat16 over bfloat16) and for head_dim 64 (smollm-135m); anything else
// returns cudaErrorInvalidValue.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_new,
                                   const void* v_new, const void* tables,
                                   const void* lengths, void* out, int B,
                                   int KV, int G, int hd, int BS, int NBT,
                                   int q_dtype, int pool_dtype, float scale,
                                   void* stream) {
  if (B < 1 || KV < 1 || G < 1 || G > GMAX || BS < 1 || NBT < 1 ||
      B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* n = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && pool_dtype == 0)
    err = launch_hd<float, float>(hd, q, k_pages, v_pages, k_new, v_new, t, n, out, B, KV, G, BS, NBT, scale, st);
  else if (q_dtype == 0 && pool_dtype == 1)
    err = launch_hd<float, bf16>(hd, q, k_pages, v_pages, k_new, v_new, t, n, out, B, KV, G, BS, NBT, scale, st);
  else if (q_dtype == 1 && pool_dtype == 1)
    err = launch_hd<bf16, bf16>(hd, q, k_pages, v_pages, k_new, v_new, t, n, out, B, KV, G, BS, NBT, scale, st);
  return (int)err;
}
