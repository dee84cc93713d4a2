// Multi-level 2D deformable attention, forward, gathering from global
// memory through L2, for Hopper (sm_90a).
//
// It replaces no TPU kernel: vln_ver_tpu/ops/pallas_deform.py samples one
// level, as deform_attn_2d.cu does.  It is added for what the staged kernel
// cannot take: several feature levels in one call (BEVFormer's spatial
// cross-attention samples four FPN levels), and maps too large for shared
// memory (a 116 x 200 level of a 32-wide fp32 head is 2.97 MB, the
// 200 x 200 BEV that the temporal self-attention and the decoder sample
// 5.1 MB, against 227 KB a block).  It computes
//
//   out[b, q, h*d + c] = sum_l sum_p w[b, q, h, l, p] *
//                        bilinear(V[b, start_l:, h, c] as H_l x W_l,
//                                 loc[b, q, h, l, p])
//
// with the pixel coordinate u*W_l - 0.5, v*H_l - 0.5 and every tap outside
// its level contributing zero (grid_sample, align_corners=False, zero
// padding): ops/deform_attn.ms_deform_attn_2d on the CPU.
//
// What bounds it, at BEVFormer-base's spatial cross-attention (6 camera
// slots, 4 levels of 30,825 rows, 8 heads x 32 fp32, 8 points a level,
// about 13,000 query slots a camera): device memory reads the value once,
// 190 MB, plus locations and weights, 128 MB, and writes 80 MB, about
// 0.12 ms at 3.35 TB/s; but each valid tap reads a 128-byte row of one
// head, 4 taps x 32 points x 8 heads x 6 x 13,000 = 80M rows, about 10 GB
// a call.  One camera's four levels (31.6 MB over all heads) fit in the
// 50 MB L2, all six (190 MB) do not: the bound that matters is the rate at
// which L2 and L1 serve scattered 128-byte rows, not HBM and not the
// 0.64 GFLOP of fp32 work.
//
// Design.
//  1. No staging: a tap reads its row straight from global memory through
//     the read-only path (__ldg), so any map size and any number of levels
//     is taken.  Neighbouring taps of neighbouring queries share rows, and
//     L1 catches some of that reuse.
//  2. Work items are (slot, query, head) triples numbered slot-major, one
//     warp takes `items_per_warp` consecutive ones and blocks are issued in
//     order, so the queries of one (batch, camera) slot run together while
//     its maps sit in L2, and consecutive warps share a query's locations.
//  3. A warp walks its item's L x P points 32 at a time: lane i loads point
//     i's location (float2) and weight, computes its four taps' rows and
//     combined weights once (bounds tested in float before any int
//     conversion, so a NaN location fails them), then the warp takes the
//     points in turn, each lane receiving the point's taps by shuffle.  A
//     tap outside its level is skipped by every lane alike (no divergence),
//     so an inf in V never meets a zero weight.
//  4. Channels: lane l owns channels l + 32k (fp32) or the pair
//     2(l + 32k) (bf16), k below a compile-time count KC, so a tap's row is
//     one or a few fully coalesced 128-byte reads and every accumulator
//     index is a constant.  All four taps' loads of a point are issued
//     before their FMAs.
//  5. Narrow heads (d <= 16; TPVFormer's 128 channels in 8 heads): under
//     design 4 lanes 16-31 would hold no channel (fp32) and in bf16 lanes
//     8-31 none, idle on every tap.  The narrow kernel gives each point a
//     group of G lanes, 16 in fp32 (one channel each) and 8 in bf16 (a
//     pair each), so that a warp step takes 32 / G points, one a group;
//     each group gets its point's taps by shuffle from the lane that set
//     them up, and a tap's row is one 64- or 32-byte read a group.  At the
//     item's end the groups' partial sums are added by xor-shuffles and
//     the first group writes the row.  The wide kernel (d > 16) is as in
//     4; ops/deform_cuda.plan_gather picks the layout by d.
// What is left: the shuffles and tap setup cost each point about as many
// warp instructions as its loads; a per-camera schedule that keeps one
// slot's levels resident is later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLevels = 16;
constexpr int kMaxHeadDim = 256;

struct Params {
  const void* value;
  const float* loc;
  const float* weight;
  void* out;
  int nv, heads, d, nq, L, P;
  long long items;
  int items_per_warp;
  int H[kMaxLevels], W[kMaxLevels], start[kMaxLevels];
};

template <typename T> struct LaneVals;
template <> struct LaneVals<float> { static constexpr int kN = 1; };
template <> struct LaneVals<__nv_bfloat16> { static constexpr int kN = 2; };

__device__ __forceinline__ void load_ro(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load_ro(const __nv_bfloat16* p,
                                        float (&v)[2]) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  __nv_bfloat162 pair;
  pair.x = __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu));
  pair.y = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  const float2 f = __bfloat1622float2(pair);
  v[0] = f.x;
  v[1] = f.y;
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
    msda_gather_kernel(const Params prm) {
  constexpr int kN = LaneVals<T>::kN;
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  if (threadIdx.x < prm.L) {
    s_h[threadIdx.x] = prm.H[threadIdx.x];
    s_w[threadIdx.x] = prm.W[threadIdx.x];
    s_start[threadIdx.x] = prm.start[threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int heads = prm.heads, d = prm.d, nq = prm.nq, P = prm.P;
  const int LP = prm.L * P;
  const long long row_elems = static_cast<long long>(heads) * d;
  const T* value = static_cast<const T*>(prm.value);
  T* out = static_cast<T*>(prm.out);
  const float2* loc2 = reinterpret_cast<const float2*>(prm.loc);

  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) *
      prm.items_per_warp;
  for (int it = 0; it < prm.items_per_warp; ++it) {
    const long long item = first + it;
    if (item >= prm.items) return;
    // item = (b * nq + q) * heads + h: locations, weights and the output
    // row of the item start at item * LP and item * d
    const long long bq = item / heads;
    const int h = static_cast<int>(item - bq * heads);
    const long long b = bq / nq;
    const T* vbase = value + b * prm.nv * row_elems + h * d + lane * kN;

    float acc[KC * kN];
#pragma unroll
    for (int k = 0; k < KC * kN; ++k) acc[k] = 0.f;

    for (int c0 = 0; c0 < LP; c0 += 32) {
      // this lane's point: its four taps' rows (-1 outside the level) and
      // weights
      const int p = c0 + lane;
      int r[4] = {-1, -1, -1, -1};
      float tw[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < LP) {
        const float2 l = __ldg(loc2 + item * LP + p);
        const float aw = __ldg(prm.weight + item * LP + p);
        const int lvl = p / P;
        const int Hl = s_h[lvl], Wl = s_w[lvl];
        const float fW = static_cast<float>(Wl), fH = static_cast<float>(Hl);
        const float x = __fsub_rn(__fmul_rn(l.x, fW), 0.5f);
        const float y = __fsub_rn(__fmul_rn(l.y, fH), 0.5f);
        const float x0 = floorf(x), y0 = floorf(y);
        const float ax = x - x0, ay = y - y0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int dx = t & 1, dy = t >> 1;
          const float xt = x0 + static_cast<float>(dx);
          const float yt = y0 + static_cast<float>(dy);
          if (xt >= 0.f && xt <= fW - 1.f && yt >= 0.f && yt <= fH - 1.f) {
            r[t] = s_start[lvl] + static_cast<int>(yt) * Wl +
                   static_cast<int>(xt);
            tw[t] = aw * (dy ? ay : 1.f - ay) * (dx ? ax : 1.f - ax);
          }
        }
      }
      const int n = min(32, LP - c0);
      for (int j = 0; j < n; ++j) {
        int rj[4];
        float wj[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          rj[t] = __shfl_sync(0xffffffffu, r[t], j);
          wj[t] = __shfl_sync(0xffffffffu, tw[t], j);
        }
        float v[4][KC][kN];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            const int c = (lane + 32 * k) * kN;
            if (rj[t] >= 0 && c < d) {
              load_ro(vbase + rj[t] * row_elems + 32 * kN * k, v[t][k]);
            } else {
#pragma unroll
              for (int e = 0; e < kN; ++e) v[t][k][e] = 0.f;
            }
          }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int k = 0; k < KC; ++k)
#pragma unroll
            for (int e = 0; e < kN; ++e)
              acc[k * kN + e] = fmaf(wj[t], v[t][k][e], acc[k * kN + e]);
      }
    }
    T* orow = out + item * d;
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int c = (lane + 32 * k) * kN + e;
        if (c < d) store_val(orow + c, acc[k * kN + e]);
      }
  }
}

// Design 5: heads of at most 16 channels, G = 16 / kN lanes a point.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    msda_gather_kernel_narrow(const Params prm) {
  constexpr int kN = LaneVals<T>::kN;
  constexpr int kG = 16 / kN;          // lanes a point
  constexpr int kStep = 32 / kG;       // points a warp step
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  if (threadIdx.x < prm.L) {
    s_h[threadIdx.x] = prm.H[threadIdx.x];
    s_w[threadIdx.x] = prm.W[threadIdx.x];
    s_start[threadIdx.x] = prm.start[threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane / kG;         // the point of the step it takes
  const int c = (lane % kG) * kN;      // its first channel
  const int heads = prm.heads, d = prm.d, nq = prm.nq, P = prm.P;
  const int LP = prm.L * P;
  const long long row_elems = static_cast<long long>(heads) * d;
  const T* value = static_cast<const T*>(prm.value);
  T* out = static_cast<T*>(prm.out);
  const float2* loc2 = reinterpret_cast<const float2*>(prm.loc);

  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) *
      prm.items_per_warp;
  for (int it = 0; it < prm.items_per_warp; ++it) {
    const long long item = first + it;
    if (item >= prm.items) return;
    const long long bq = item / heads;
    const int h = static_cast<int>(item - bq * heads);
    const long long b = bq / nq;
    const T* vbase = value + b * prm.nv * row_elems + h * d + c;

    float acc[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[e] = 0.f;

    for (int c0 = 0; c0 < LP; c0 += 32) {
      // as the wide kernel: lane i sets up point c0 + i's taps
      const int p = c0 + lane;
      int r[4] = {-1, -1, -1, -1};
      float tw[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < LP) {
        const float2 l = __ldg(loc2 + item * LP + p);
        const float aw = __ldg(prm.weight + item * LP + p);
        const int lvl = p / P;
        const int Hl = s_h[lvl], Wl = s_w[lvl];
        const float fW = static_cast<float>(Wl), fH = static_cast<float>(Hl);
        const float x = __fsub_rn(__fmul_rn(l.x, fW), 0.5f);
        const float y = __fsub_rn(__fmul_rn(l.y, fH), 0.5f);
        const float x0 = floorf(x), y0 = floorf(y);
        const float ax = x - x0, ay = y - y0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int dx = t & 1, dy = t >> 1;
          const float xt = x0 + static_cast<float>(dx);
          const float yt = y0 + static_cast<float>(dy);
          if (xt >= 0.f && xt <= fW - 1.f && yt >= 0.f && yt <= fH - 1.f) {
            r[t] = s_start[lvl] + static_cast<int>(yt) * Wl +
                   static_cast<int>(xt);
            tw[t] = aw * (dy ? ay : 1.f - ay) * (dx ? ax : 1.f - ax);
          }
        }
      }
      const int n = min(32, LP - c0);
      for (int j = 0; j < n; j += kStep) {
        // group g takes point j + g; a source lane at or past n holds no
        // tap (its point is past LP)
        const int src = j + group;
        int rj[4];
        float wj[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          rj[t] = __shfl_sync(0xffffffffu, r[t], src);
          wj[t] = __shfl_sync(0xffffffffu, tw[t], src);
        }
        float v[4][kN];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (rj[t] >= 0 && c < d) {
            load_ro(vbase + rj[t] * row_elems, v[t]);
          } else {
#pragma unroll
            for (int e = 0; e < kN; ++e) v[t][e] = 0.f;
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < kN; ++e) acc[e] = fmaf(wj[t], v[t][e], acc[e]);
      }
    }
    // the groups' partial sums, added across the warp
#pragma unroll
    for (int off = 16; off >= kG; off >>= 1)
#pragma unroll
      for (int e = 0; e < kN; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    if (group == 0) {
      T* orow = out + item * d;
#pragma unroll
      for (int e = 0; e < kN; ++e)
        if (c + e < d) store_val(orow + c + e, acc[e]);
    }
  }
}

template <typename T>
cudaError_t launch_narrow(const Params& prm, long long blocks,
                          cudaStream_t st) {
  msda_gather_kernel_narrow<T>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(prm);
  return cudaGetLastError();
}

template <typename T, int KC>
cudaError_t launch(const Params& prm, long long blocks, cudaStream_t st) {
  msda_gather_kernel<T, KC>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(prm);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Params& prm, int kc, long long blocks,
                       cudaStream_t st) {
  switch (kc) {
    case 1: return launch<float, 1>(prm, blocks, st);
    case 2: return launch<float, 2>(prm, blocks, st);
    case 3: return launch<float, 3>(prm, blocks, st);
    case 4: return launch<float, 4>(prm, blocks, st);
    case 5: return launch<float, 5>(prm, blocks, st);
    case 6: return launch<float, 6>(prm, blocks, st);
    case 7: return launch<float, 7>(prm, blocks, st);
    case 8: return launch<float, 8>(prm, blocks, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const Params& prm, int kc, long long blocks,
                        cudaStream_t st) {
  switch (kc) {
    case 1: return launch<__nv_bfloat16, 1>(prm, blocks, st);
    case 2: return launch<__nv_bfloat16, 2>(prm, blocks, st);
    case 3: return launch<__nv_bfloat16, 3>(prm, blocks, st);
    case 4: return launch<__nv_bfloat16, 4>(prm, blocks, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  value (bs, nv, heads, d) fp32 or
// bf16 (bf16: d even), nv the levels' rows concatenated; shapes the L
// levels' (H, W) as 2L ints on the host; loc (bs, nq, heads, L, P, 2) fp32,
// 8-byte aligned; weight (bs, nq, heads, L, P) fp32; out (bs, nq, heads*d)
// in the value type.  All contiguous, all on the current device.
// point_lanes, items_per_warp and blocks are the plan of
// ops/deform_cuda.plan_gather: point_lanes 32 takes the wide kernel, 16
// (fp32) or 8 (bf16) the narrow one, which takes d <= 16.  Returns
// cudaErrorInvalidValue for a plan or shape the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int msda_gather_forward(const void* value, const void* loc,
                                   const void* weight, void* out, int bs,
                                   int nv, int heads, int d, int nq, int L,
                                   int P, const int* shapes,
                                   int value_is_bf16, int point_lanes,
                                   int items_per_warp, long long blocks,
                                   void* stream) {
  const int narrow_lanes = value_is_bf16 ? 8 : 16;
  if (bs < 1 || nv < 1 || heads < 1 || nq < 1 || P < 1 || d < 1 ||
      d > kMaxHeadDim || L < 1 || L > kMaxLevels || items_per_warp < 1 ||
      (value_is_bf16 && d % 2 != 0) ||
      reinterpret_cast<uintptr_t>(loc) % 8 != 0 ||
      (point_lanes != 32 && (point_lanes != narrow_lanes || d > 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  long long rows = 0;
  for (int l = 0; l < L; ++l) {
    const int H = shapes[2 * l], W = shapes[2 * l + 1];
    if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
    prm.H[l] = H;
    prm.W[l] = W;
    prm.start[l] = static_cast<int>(rows);
    rows += static_cast<long long>(H) * W;
  }
  const long long items = static_cast<long long>(bs) * nq * heads;
  const long long per_block = static_cast<long long>(kWarps) * items_per_warp;
  if (rows != nv || blocks != (items + per_block - 1) / per_block ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  prm.value = value;
  prm.loc = static_cast<const float*>(loc);
  prm.weight = static_cast<const float*>(weight);
  prm.out = out;
  prm.nv = nv;
  prm.heads = heads;
  prm.d = d;
  prm.nq = nq;
  prm.L = L;
  prm.P = P;
  prm.items = items;
  prm.items_per_warp = items_per_warp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (point_lanes != 32) {
    const cudaError_t err =
        value_is_bf16 ? launch_narrow<__nv_bfloat16>(prm, blocks, s)
                      : launch_narrow<float>(prm, blocks, s);
    return static_cast<int>(err);
  }
  const int kc = value_is_bf16 ? (d + 63) / 64 : (d + 31) / 32;
  const cudaError_t err = value_is_bf16 ? launch_bf16(prm, kc, blocks, s)
                                        : launch_f32(prm, kc, blocks, s);
  return static_cast<int>(err);
}
