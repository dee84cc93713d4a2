// Single-level 2D deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of vln_ver_tpu/ops/pallas_deform.py:
// `_kernel` (ms_deform_attn_2d_pallas) and `_kernel_v2`
// (ms_deform_attn_2d_pallas_v2), which compute the same function:
//
//   out[b, q, h*d + c] = sum_p w[b, q, h, p] * bilinear(V[b, :, h, c] as H x W,
//                                                      loc[b, q, h, p])
//
// with the pixel coordinate u*W - 0.5, v*H - 0.5 and every tap outside the
// map contributing zero (grid_sample, align_corners=False, zero padding).
// The TPU kernels built a dense one-hot interpolation matrix and applied it
// with a matrix product, because gathers are slow there.  Here it is a
// gather kernel: the bilinear taps are read straight from shared memory.
//
// What bounds it, at the main-path shape with batch 1 (bs = 6 camera slots,
// 14 x 14 values, 8 heads x 96, 8 points, 900 queries, fp32):
//  - device memory: value 3.61 MB + loc 2.76 MB + weights 1.38 MB in and
//    out 16.59 MB = 24.3 MB, 7.3 us at 3.35 TB/s;
//  - shared memory: each tap inside the map reads its row's d values,
//    4 taps x 96 x 4 B x 8 points x 900 x 8 heads x 6 slots = 531 MB when
//    every tap lands inside, about 16 us at 128 B per clock on 132 SMs at
//    1.98 GHz (33 TB/s).  A gather cannot read less, so this floor, not
//    the 7.3 us, is what the kernel works against; bf16 values halve it;
//  - fp32 work: 0.27 GFLOP, 4 us at 67 TFLOP/s.
// All three scale with the batch.
//
// Design.  The launch plan (chunk, items, CTAs, stages, row stride, stage
// and shared-memory bytes) comes from plan_launch in ops/deform_cuda.py,
// which the CPU tests check; the entry point below refuses a plan that
// does not fit these shapes.  A CTA is one producer warp and 24 consumer
// warps.
//  1. Staging overlaps compute.  The producer warp copies V[b, :, h, :]
//     (hw rows of d values; row stride heads*d in global memory) into a
//     ring of `stages` tiles (2 where two fit) with one TMA copy per tile:
//     value is described to the TMA unit as a 4D tensor (d, heads, W,
//     bs*H) and the tile is the box (d, 1, W, H) at (0, h, 0, b*H), so the
//     copy engine moves a whole tile per request rather than one small
//     bulk copy per row.  The copy completes on the stage's `full`
//     mbarrier, armed with expect_tx for the whole tile.  The next tile
//     lands while the consumers work on the current one; an `empty`
//     mbarrier per stage guards reuse.  Rows whose byte length or address
//     is not a multiple of 16 (the TMA unit's unit), and maps over 256 a
//     side (its box limit), are copied by the producer's 32 lanes with
//     plain loads into the same ring, under the same barriers.
//  2. Each V tile is staged once per CTA.  The grid is persistent, one CTA
//     per SM at most.  Work items are (slot, head, query chunk) triples,
//     numbered so that consecutive items share a (slot, head); each CTA
//     takes a contiguous run of items and walks all of its queries of one
//     (slot, head) on one staged tile.
//  3. Locations and weights are prefetched, and the channel loop has no
//     branches.  A consumer warp takes one query at a time, 8 points x 4
//     taps = 32 lanes.  It loads locations (float2) and weights for four
//     queries x 8 points at once, lane 8i + p taking point p of the i-th,
//     one such block ahead of its use, so a load has four queries' work to
//     arrive in.  For each query the warp hands point p to lanes 4p..4p+3
//     by shuffle; each lane computes its tap's row and combined weight
//     once, testing the bounds in float before any int conversion, and the
//     warp packs the taps that land inside the map into a per-warp list in
//     shared memory (ballot + popc) as (byte offset, weight).  The channel
//     loop walks only that list, four taps at a time: an invalid tap never
//     enters the sum, so an inf in V cannot turn into a NaN there.
//  4. No spills.  The channels a lane owns (KC loads of 1 fp32 or 2 bf16
//     values, 32 lanes apart) are a compile-time count, one instantiation
//     per KC, so every accumulator index is a constant; d stays a runtime
//     argument up to 256.  A lane reads all KC loads of a row, past d into
//     the tile's slack, and stores only channels below d.
// What is left: each valid tap costs a warp its loads and FMAs plus an
// address add, and each query a tap setup on top, so the kernel is bound
// by instruction issue, above both floors (PERF.md).  bf16 pays two more
// instructions per load to widen the pair to fp32.

#include "deform_common.cuh"

namespace {

constexpr int kConsumerWarps = 24;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kPointsPerStep = 8;  // x 4 taps = one warp
constexpr int kMaxStages = 2;
constexpr int kMaxHeadDim = 256;
// Shared memory: [full and empty mbarriers | one 32-entry tap list per
// consumer warp | stage 0 | stage 1].  ops/deform_cuda.py mirrors
// kHeaderBytes as HEADER_BYTES.
constexpr int kBarrierBytes = 128;
constexpr int kTapListBytes = 32 * 8;
constexpr int kHeaderBytes = kBarrierBytes + kConsumerWarps * kTapListBytes;

struct Params {
  const void* value;
  const float* loc;
  const float* weight;
  void* out;
  int H, W, heads, d, nq, P;
  int chunk, n_items, items_per_cta, stages, row_stride, stage_bytes, tma;
};

// acc += w_i * V[row_i, lane's channels] for four taps (byte offset, weight
// bits).  All loads are issued before the FMAs.
template <typename T, int KC>
__device__ __forceinline__ void gather4(const T* vs, int4 t01, int4 t23,
                                        float (&acc)[KC * LaneVals<T>::kN]) {
  constexpr int kN = LaneVals<T>::kN;
  const T* row[4] = {row_at(vs, t01.x), row_at(vs, t01.z),
                     row_at(vs, t23.x), row_at(vs, t23.z)};
  const float w[4] = {__int_as_float(t01.y), __int_as_float(t01.w),
                      __int_as_float(t23.y), __int_as_float(t23.w)};
  float v[4][KC][kN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KC; ++k) load_vals(row[i] + 32 * kN * k, v[i][k]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < kN; ++e)
        acc[k * kN + e] = fmaf(w[i], v[i][k][e], acc[k * kN + e]);
}

template <typename T, int KC>
__device__ __forceinline__ void gather1(const T* vs, int2 t,
                                        float (&acc)[KC * LaneVals<T>::kN]) {
  constexpr int kN = LaneVals<T>::kN;
  const float w = __int_as_float(t.y);
  const T* row = row_at(vs, t.x);
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    float v[kN];
    load_vals(row + 32 * kN * k, v);
#pragma unroll
    for (int e = 0; e < kN; ++e)
      acc[k * kN + e] = fmaf(w, v[e], acc[k * kN + e]);
  }
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads, 1)
    deform_attn_2d_kernel(const __grid_constant__ CUtensorMap vmap,
                          const Params prm) {
  constexpr int kN = LaneVals<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* tiles = smem + kHeaderBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stages = prm.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int heads = prm.heads, d = prm.d, nq = prm.nq;
  const int hw = prm.H * prm.W;
  // This CTA's run of items [i0, i1) covers the (slot, head) pairs
  // first..last: queries [q_first, nq) of `first`, all of the pairs
  // between, and [0, q_last) of `last`.
  const int chunks = (nq + prm.chunk - 1) / prm.chunk;
  const int i0 = blockIdx.x * prm.items_per_cta;
  const int i1 = min(prm.n_items, i0 + prm.items_per_cta);
  const int first = i0 / chunks;
  const int last = (i1 - 1) / chunks;
  const int q_first = (i0 - first * chunks) * prm.chunk;
  const int q_last = min(nq, (i1 - last * chunks) * prm.chunk);

  if (warp == kConsumerWarps) {
    // ---- producer: stage V[b, :, h, :] of each pair into the ring ----
    const T* value = static_cast<const T*>(prm.value);
    const size_t src_row = static_cast<size_t>(heads) * d;
    const uint32_t tile_bytes = static_cast<uint32_t>(hw * d * sizeof(T));
    for (int pair = first; pair <= last; ++pair) {
      const int j = pair - first;
      const int s = j % stages;
      if (j >= stages) mbar_wait(&empty[s], (j / stages - 1) & 1);
      T* dst = reinterpret_cast<T*>(tiles + static_cast<size_t>(s) *
                                                prm.stage_bytes);
      const int b = pair / heads;
      const int h = pair - b * heads;
      if (prm.tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], tile_bytes);
          tma_load_4d(dst, &vmap, 0, h, 0, b * prm.H, &full[s]);
        } else {
          mbar_arrive(&full[s]);
        }
      } else {
        const T* src = value + (static_cast<size_t>(b) * hw * heads + h) * d;
#pragma unroll 4
        for (int i = lane; i < hw * d; i += 32) {
          const int r = i / d;
          const int c = i - r * d;
          dst[static_cast<size_t>(r) * prm.row_stride + c] =
              src[r * src_row + c];
        }
        mbar_arrive(&full[s]);  // release: orders this lane's stores
      }
    }
    return;
  }

  // ---- consumers ----
  int2* taps = reinterpret_cast<int2*>(smem + kBarrierBytes) + warp * 32;
  const int4* taps4 = reinterpret_cast<const int4*>(taps);
  const float2* loc2 = reinterpret_cast<const float2*>(prm.loc);
  T* out = static_cast<T*>(prm.out);
  const float fW = static_cast<float>(prm.W);
  const float fH = static_cast<float>(prm.H);
  const int P = prm.P;
  // A step is one query's group of 8 points; a query has `steps` of them.
  // A warp walks its steps in blocks of four.
  const int steps = max(1, (P + kPointsPerStep - 1) / kPointsPerStep);
  const int pt = lane >> 2;  // this lane's point within a step
  const int dx = lane & 1;
  const int dy = (lane >> 1) & 1;
  const unsigned below = (1u << lane) - 1u;
  const int row_bytes = prm.row_stride * static_cast<int>(sizeof(T));

  for (int pair = first; pair <= last; ++pair) {
    const int j = pair - first;
    const int s = j % stages;
    const int b = pair / heads;
    const int h = pair - b * heads;
    const int q_end = pair == last ? q_last : nq;

    // locations and weights of (slot b, query 0, head h); a query's are
    // heads * P further on
    const size_t qh0 = (static_cast<size_t>(b) * nq * heads + h) * P;
    const float2* loc_bh = loc2 + qh0;
    const float* w_bh = prm.weight + qh0;
    const int q_stride = heads * P;
    T* out_bh = out + (static_cast<size_t>(b) * nq * heads + h) * d;
    // Lane 8i + p loads point p of step i of the block that starts at
    // step (bq, bg): query bq, point group bg.
    auto load_block = [&](int bq, int bg, float2& l, float& w) {
      int lq = bq, lg = bg + (lane >> 3);
      if (steps == 1) {
        lq += lg * kConsumerWarps;
        lg = 0;
      } else {
        lq += (lg / steps) * kConsumerWarps;
        lg %= steps;
      }
      const int p = lg * kPointsPerStep + (lane & 7);
      if (lq < q_end && p < P) {
        const size_t o = static_cast<size_t>(lq) * q_stride + p;
        l = __ldg(loc_bh + o);
        w = __ldg(w_bh + o);
      }
    };
    int bq = (pair == first ? q_first : 0) + warp;
    int bg = 0;
    float2 cur_loc = make_float2(0.f, 0.f), next_loc = cur_loc;
    float cur_w = 0.f, next_w = 0.f;
    load_block(bq, bg, cur_loc, cur_w);  // before the wait: overlaps it
    mbar_wait(&full[s], (j / stages) & 1);
    const T* vs = reinterpret_cast<const T*>(
                      tiles + static_cast<size_t>(s) * prm.stage_bytes) +
                  lane * kN;

    float acc[KC * kN];
#pragma unroll
    for (int k = 0; k < KC * kN; ++k) acc[k] = 0.f;

    while (bq < q_end) {
      const int ahead = steps == 1 ? 4 : (bg + 4) / steps;
      const int nbq = bq + ahead * kConsumerWarps;
      const int nbg = steps == 1 ? 0 : (bg + 4) % steps;
      load_block(nbq, nbg, next_loc, next_w);
      int q = bq, g = bg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q >= q_end) break;
        const int src = i * 8 + pt;
        const float lx = __shfl_sync(0xffffffffu, cur_loc.x, src);
        const float ly = __shfl_sync(0xffffffffu, cur_loc.y, src);
        const float aw = __shfl_sync(0xffffffffu, cur_w, src);
        const int p = g * kPointsPerStep + pt;

        // this lane's tap; the bounds are tested in float, a NaN fails them
        const float x = __fsub_rn(__fmul_rn(lx, fW), 0.5f);
        const float y = __fsub_rn(__fmul_rn(ly, fH), 0.5f);
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        const float xt = x0 + static_cast<float>(dx);
        const float yt = y0 + static_cast<float>(dy);
        const bool ok = p < P && xt >= 0.f && xt <= fW - 1.f && yt >= 0.f &&
                        yt <= fH - 1.f;
        const float ax = x - x0;
        const float ay = y - y0;
        const float tw = aw * (dy ? ay : 1.f - ay) * (dx ? ax : 1.f - ax);
        const unsigned mask = __ballot_sync(0xffffffffu, ok);
        if (ok)  // xt, yt are in range here: the casts are exact
          taps[__popc(mask & below)] = make_int2(
              (static_cast<int>(yt) * prm.W + static_cast<int>(xt)) *
                  row_bytes,
              __float_as_int(tw));
        __syncwarp();
        const int n = __popc(mask);
        int k = 0;
        for (; k + 4 <= n; k += 4)
          gather4<T, KC>(vs, taps4[k >> 1], taps4[(k >> 1) + 1], acc);
        for (; k < n; ++k) gather1<T, KC>(vs, taps[k], acc);
        __syncwarp();  // the list is rewritten next step

        if (g == steps - 1) {
          T* orow = out_bh + static_cast<size_t>(q) * heads * d;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
#pragma unroll
            for (int e = 0; e < kN; ++e) {
              const int c = (lane + 32 * kc) * kN + e;
              if (c < d) store_val(orow + c, acc[kc * kN + e]);
              acc[kc * kN + e] = 0.f;
            }
          g = 0;
          q += kConsumerWarps;
        } else {
          ++g;
        }
      }
      cur_loc = next_loc;
      cur_w = next_w;
      bq = nbq;
      bg = nbg;
    }
    // every consumer warp waits for every tile before it releases it, so
    // no warp can arrive twice within one phase of `empty`
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

template <typename T, int KC>
cudaError_t launch(const CUtensorMap& vmap, const Params& prm, int ctas,
                   int smem_bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      deform_attn_2d_kernel<T, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  deform_attn_2d_kernel<T, KC>
      <<<ctas, kThreads, smem_bytes, stream>>>(vmap, prm);
  return cudaGetLastError();
}

cudaError_t launch_f32(const CUtensorMap& m, const Params& prm, int kc,
                       int ctas, int smem, cudaStream_t st) {
  switch (kc) {
    case 1: return launch<float, 1>(m, prm, ctas, smem, st);
    case 2: return launch<float, 2>(m, prm, ctas, smem, st);
    case 3: return launch<float, 3>(m, prm, ctas, smem, st);
    case 4: return launch<float, 4>(m, prm, ctas, smem, st);
    case 5: return launch<float, 5>(m, prm, ctas, smem, st);
    case 6: return launch<float, 6>(m, prm, ctas, smem, st);
    case 7: return launch<float, 7>(m, prm, ctas, smem, st);
    case 8: return launch<float, 8>(m, prm, ctas, smem, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const CUtensorMap& m, const Params& prm, int kc,
                        int ctas, int smem, cudaStream_t st) {
  switch (kc) {
    case 1: return launch<__nv_bfloat16, 1>(m, prm, ctas, smem, st);
    case 2: return launch<__nv_bfloat16, 2>(m, prm, ctas, smem, st);
    case 3: return launch<__nv_bfloat16, 3>(m, prm, ctas, smem, st);
    case 4: return launch<__nv_bfloat16, 4>(m, prm, ctas, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  value (bs, H*W, heads, d) fp32 or
// bf16; loc (bs, nq, heads, 1, P, 2) fp32, 8-byte aligned; weight
// (bs, nq, heads, 1, P) fp32; out (bs, nq, heads*d) in the value type.  All
// contiguous, all on the current device.  chunk .. smem_bytes are the launch
// plan of ops/deform_cuda.plan_launch.  Returns cudaErrorInvalidValue for a
// plan or shape the kernel does not take, else cudaGetLastError() after the
// launch.
extern "C" int deform_attn_2d_forward(const void* value, const void* loc,
                                      const void* weight, void* out, int bs,
                                      int H, int W, int heads, int d, int nq,
                                      int P, int value_is_bf16, int chunk,
                                      int n_items, int items_per_cta, int ctas,
                                      int stages, int row_stride,
                                      int stage_bytes, int smem_bytes,
                                      void* stream) {
  const long long elt = value_is_bf16 ? 2 : 4;
  const int lane_vals = value_is_bf16 ? 2 : 1;
  if (bs < 1 || H < 1 || W < 1 || heads < 1 || nq < 1 || P < 0 || d < 1 ||
      d > kMaxHeadDim || chunk < 1 || items_per_cta < 1 || ctas < 1 ||
      stages < 1 || stages > kMaxStages ||
      reinterpret_cast<uintptr_t>(loc) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = (d + 32 * lane_vals - 1) / (32 * lane_vals);
  const long long chunks = (nq + chunk - 1) / chunk;
  const long long hw = static_cast<long long>(H) * W;
  if (n_items != static_cast<long long>(bs) * heads * chunks ||
      static_cast<long long>(ctas) * items_per_cta < n_items ||
      static_cast<long long>(ctas - 1) * items_per_cta >= n_items ||
      row_stride < d || (row_stride * elt) % 4 != 0 ||
      stage_bytes % 128 != 0 ||
      (hw - 1) * row_stride * elt + 128LL * kc > stage_bytes ||
      kHeaderBytes + static_cast<long long>(stages) * stage_bytes > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);

  Params prm;
  prm.value = value;
  prm.loc = static_cast<const float*>(loc);
  prm.weight = static_cast<const float*>(weight);
  prm.out = out;
  prm.H = H;
  prm.W = W;
  prm.heads = heads;
  prm.d = d;
  prm.nq = nq;
  prm.P = P;
  prm.chunk = chunk;
  prm.n_items = n_items;
  prm.items_per_cta = items_per_cta;
  prm.stages = stages;
  prm.row_stride = row_stride;
  prm.stage_bytes = stage_bytes;
  // the TMA unit takes 16-byte rows at 16-byte addresses, boxes <= 256
  prm.tma = tma_takes(value, d, static_cast<int>(elt), row_stride, H, W);
  alignas(64) CUtensorMap vmap = {};
  if (prm.tma) {
    const cudaError_t err =
        encode_value_map(&vmap, value, value_is_bf16, bs, H, W, heads, d);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      value_is_bf16 ? launch_bf16(vmap, prm, kc, ctas, smem_bytes, s)
                    : launch_f32(vmap, prm, kc, ctas, smem_bytes, s);
  return static_cast<int>(err);
}
