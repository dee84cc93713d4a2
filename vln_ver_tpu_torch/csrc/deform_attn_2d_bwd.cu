// Single-level 2D deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the VJP of vln_ver_tpu/ops/pallas_deform.py
// (`ms_deform_attn_2d_pallas`'s custom_vjp `_bwd`, which differentiates the
// one-hot XLA form of `_kernel`).  For the forward of deform_attn_2d.cu,
//
//   out[b, q, h*d + c] = sum_p w[b, q, h, p] * bilinear(V[b, :, h, c],
//                                                      loc[b, q, h, p]),
//
// and the output gradient g (bs, nq, heads*d), it computes, for each slot b,
// query q, head h and point p, with x = loc_x*W - 0.5, y = loc_y*H - 0.5,
// ax, ay their fractional parts, D_ij = sum_c g[c] * V[tap ij, c] the dot
// product of tap (floor(y)+i, floor(x)+j) with g, and every tap outside the
// map zero (tested in float, so a far-out location never wraps an int):
//
//   dV[b, tap ij, h, c] += w * (i ? ay : 1-ay) * (j ? ax : 1-ax) * g[c]
//   dw[b, q, h, p]       = sum_ij (i ? ay : 1-ay) * (j ? ax : 1-ax) * D_ij
//   dloc_x[b, q, h, p]   = W * w * ((1-ay)(D01 - D00) + ay(D11 - D10))
//   dloc_y[b, q, h, p]   = H * w * ((1-ax)(D10 - D00) + ax(D11 - D01))
//
// which is what autograd gives for the plain version (ops/sampling.py).
//
// What bounds it, at the main-path shape with batch 1 (bs = 6 camera slots,
// 14 x 14 values, 8 heads x 96, 8 points, 900 queries, fp32):
//  - device memory: value 3.61 MB + loc 2.76 MB + w 1.38 MB + g 16.59 MB in
//    and dV 3.61 MB + dloc 2.76 MB + dw 1.38 MB out = 32.1 MB, 9.6 us at
//    3.35 TB/s;
//  - shared memory: every tap inside the map reads its row's d values once
//    (for D) and adds d fp32 values into dV once (a read and a write), so
//    d x (elt + 8) bytes a tap: on locations in [-0.1, 1.1] (69 % of the
//    taps inside) about 1.1 GB, 33 us at 128 B per clock on 132 SMs.  That
//    floor, three times the forward's, is what the kernel works against.
//
// Design.  ops/deform_cuda.plan_backward cuts the work and the CPU tests
// check the cut.  The grid holds CTAs of two kinds, 8 warps each:
//  1. Value CTAs, first in the grid: `qsplit` of them (one thread-block
//     cluster) for each (slot, head, 32-channel slice of d).  The cluster
//     owns its slice of dV[b, :, h, :] in shared memory; its CTAs' first
//     `walkers` warps ("walkers") each take every (walkers * qsplit)-th
//     query and sum into a private fp32 copy of the slice (hw x 32), so no
//     two warps ever add into one word and no atomic is needed: fp32 adds
//     to shared memory are a compare-and-swap loop on sm_90 (ATOMS.CAST),
//     which made a first version with shared atomics as slow as the old
//     kernel's scatter.  A lane owns one channel and loads that channel of
//     the query's g.  Per step, taps that land on one row are merged
//     (__match_any_sync; the lowest lane sums their weights in lane
//     order), so the step's rows are distinct and, in chunks of 8 taps,
//     every read of the accumulators goes before every write.  At the end
//     the cluster's CTAs each sum a share of the rows over every copy of
//     every CTA, in a fixed order, through distributed shared memory, and
//     write dV with plain stores in the value type.  Each element of dV is
//     written by exactly one CTA: no global atomics, no zeroed workspace,
//     no conversion pass, and dV is bitwise reproducible.  A value CTA
//     reads no V at all.
//  2. Sums CTAs, one per (slot, head, query chunk), compute dw and dloc
//     over all d channels, so each (query, point) is summed by one warp in
//     a fixed order and dw and dloc are bitwise reproducible.  The
//     (slot, head) tile of V is staged once per CTA with one TMA tensor
//     copy under an mbarrier, the forward's 4D tensor map and box (rows
//     whose byte length or address is not a multiple of 16, and maps over
//     256 a side, are copied by the CTA's threads with plain loads); every
//     tap is read from shared memory.  Lanes own channels, contiguous, so
//     a row read never conflicts on a bank and needs no padding.  A lane
//     keeps one partial D per packed tap in registers (32 of them), the
//     warp reduces them with one 31-shuffle reduce-scatter, so that lane j
//     holds D of packed tap j, hands each D back to its tap's lane and
//     sums dw, dloc_x and dloc_y over the point's 4 lanes: no sum over 32
//     lanes per point.
//  Both kinds walk a query as steps of 8 points x 4 taps = 32 lanes, the
//  forward's lane map: each lane forms one tap (bounds in float), the warp
//  packs the taps inside the map into a per-warp list in shared memory
//  (ballot + popc), and the channel loop walks only that list.  The next
//  locations, weights and g are loaded while the current step runs.
//  The sums CTAs' queries are cut into chunks so that, with the value
//  CTAs, every SM gets about the same work (plan_backward's cost model).
// What is left: a walker's steps are a chain of dependent shared-memory
// round trips, and the private copies limit an SM to about 9 walkers, so
// the value CTAs are bound by latency, not by the shared-memory floor
// (PERF.md).  bf16 values are read as bf16 pairs and summed in fp32; dloc
// and dw are fp32 like their inputs.  A null dvalue drops the value CTAs;
// null dloc and dweight drop the sums CTAs.

#include "deform_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPointsPerStep = 8;  // x 4 taps = one warp
constexpr int kSlice = 32;         // dV channels of a value CTA, one a lane
constexpr int kMaxHeadDim = 256;
// Shared memory: [mbarrier, 128 B | region | one tap list per warp].  A
// sums CTA's region is the staged V tile (tile_bytes) and its lists hold
// 32 row offsets of 4 B; a value CTA's region is its fp32 dV slice
// (acc_bytes) and its lists hold 32 (offset, weight) pairs of 8 B.
// ops/deform_cuda.py mirrors these sizes as BWD_*.
constexpr int kBarrierBytes = 128;
constexpr int kSumListBytes = 32 * 4;
constexpr int kValueListBytes = 32 * 8;

struct BwdParams {
  const void* value;
  const float* loc;
  const float* weight;
  const void* grad_out;
  void* dvalue;    // (bs, H*W, heads, d) in the value type; may be null
  float* dloc;     // (bs, nq, heads, 1, P, 2); may be null
  float* dweight;  // (bs, nq, heads, 1, P); may be null
  int H, W, heads, d, nq, P;
  int value_ctas, slices, walkers, qsplit, sum_ctas, chunk, chunks;
  int row_stride, tile_bytes, acc_bytes, tma;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One lane's tap of one point: lane 4p + 2i + j takes tap ij of point p.
struct Tap {
  bool ok;       // inside the map
  int row;       // its row of the map where ok, else 0
  float wy, wx;  // its bilinear factors along y and x
};

__device__ __forceinline__ Tap make_tap(float2 l, float fW, float fH, int W,
                                        int lane, bool live) {
  // the plain version's arithmetic: a multiply, then a subtract
  const float x = __fsub_rn(__fmul_rn(l.x, fW), 0.5f);
  const float y = __fsub_rn(__fmul_rn(l.y, fH), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int dx = lane & 1;
  const int dy = (lane >> 1) & 1;
  const float xt = x0 + static_cast<float>(dx);
  const float yt = y0 + static_cast<float>(dy);
  Tap t;
  // a NaN fails the bounds; the casts run only where the tap is in range
  t.ok = live && xt >= 0.f && xt <= fW - 1.f && yt >= 0.f && yt <= fH - 1.f;
  const float ax = x - x0;
  const float ay = y - y0;
  t.wx = dx ? ax : 1.f - ax;
  t.wy = dy ? ay : 1.f - ay;
  t.row = t.ok ? static_cast<int>(yt) * W + static_cast<int>(xt) : 0;
  return t;
}

// The location and weight of point p of query q, where live.
__device__ __forceinline__ void load_point(const float2* loc_bh,
                                           const float* w_bh, int q_stride,
                                           int q, int p, bool live, float2& l,
                                           float& aw) {
  l = make_float2(0.f, 0.f);
  aw = 0.f;
  if (live) {
    const size_t o = static_cast<size_t>(q) * q_stride + p;
    l = __ldg(loc_bh + o);
    aw = __ldg(w_bh + o);
  }
}

// One step of the warp's reduce-scatter of dot[0 .. 2W): lane L keeps the
// half whose index bit W agrees with L's, plus the partner's same half.
// After the steps 16, 8, 4, 2, 1, dot[0] of lane L is the warp's sum of
// dot[L].
template <int kW>
__device__ __forceinline__ void reduce_scatter(float (&dot)[32], int lane) {
  const bool upper = (lane & kW) != 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const float send = upper ? dot[i] : dot[i + kW];
    const float keep = upper ? dot[i + kW] : dot[i];
    dot[i] = keep + __shfl_xor_sync(0xffffffffu, send, kW);
  }
}

// Every thread of every CTA of the cluster arrives and waits: the shared
// memory written before it is visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}
// The float at `p` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// A value CTA: dV[b, :, h, c0:c0+32].  The `qsplit` CTAs of one (b, h,
// slice) form a cluster; walker k of cluster rank r (its first `walkers`
// warps) sums the queries g, g + G, g + 2G, ... (g = r * walkers + k, G =
// walkers * qsplit) into a private copy of the slice.  At the end rank r
// adds, for its share of the rows, every copy of every rank in order and
// writes the sum.
template <typename T>
__device__ __forceinline__ void value_cta(const BwdParams& prm,
                                          unsigned char* smem, int item) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int heads = prm.heads, d = prm.d, nq = prm.nq, P = prm.P;
  const int W = prm.W;
  const int hw = prm.H * W;
  const int tile = hw * kSlice;  // floats of one copy
  const int walkers = prm.walkers;
  const int qsplit = prm.qsplit;
  const int rank = item % qsplit;
  const int unit = item / qsplit;
  const int pair = unit / prm.slices;
  const int c0 = (unit - pair * prm.slices) * kSlice;
  const int b = pair / heads;
  const int h = pair - b * heads;
  float* acc = reinterpret_cast<float*>(smem + kBarrierBytes);
  for (int i = threadIdx.x; i < walkers * tile; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  if (warp < walkers) {
    int2* list = reinterpret_cast<int2*>(smem + kBarrierBytes +
                                         walkers * prm.acc_bytes) +
                 warp * 32;
    const int4* list4 = reinterpret_cast<const int4*>(list);
    const int first = rank * walkers + warp;  // this walker's first query
    const int stride = walkers * qsplit;
    char* mine = reinterpret_cast<char*>(acc + warp * tile + lane);
    const float fW = static_cast<float>(W);
    const float fH = static_cast<float>(prm.H);
    const int steps = max(1, (P + kPointsPerStep - 1) / kPointsPerStep);
    const int pt = lane >> 2;
    const unsigned below = (1u << lane) - 1u;
    const int q_stride = heads * P;
    const size_t qh0 = (static_cast<size_t>(b) * nq * heads + h) * P;
    const float2* loc_bh = reinterpret_cast<const float2*>(prm.loc) + qh0;
    const float* w_bh = prm.weight + qh0;
    const bool live_c = c0 + lane < d;
    // g[b, q, h, c0 + lane] is at g_bh + q * g_q
    const T* g_bh = static_cast<const T*>(prm.grad_out) +
                    (static_cast<size_t>(b) * nq * heads + h) * d + c0 + lane;
    const size_t g_q = static_cast<size_t>(heads) * d;

    // The walker's steps k = 0 .. total-1: query warp + (k / steps) *
    // walkers, point group k % steps.  A block is 4 steps: lane 8i + p
    // loads point p of the block's step i, and every lane its channel of
    // g for each of the 4 steps; the next block is loaded while this one
    // runs.
    const int total =
        first < nq ? (nq - first + stride - 1) / stride * steps : 0;
    auto load_block = [&](int k0, float2& bl, float& bw, float (&bg)[4]) {
      const int k = k0 + (lane >> 3);
      const int p = (k % steps) * kPointsPerStep + (lane & 7);
      load_point(loc_bh, w_bh, q_stride, first + (k / steps) * stride, p,
                 k < total && p < P, bl, bw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = first + ((k0 + i) / steps) * stride;
        bg[i] = k0 + i < total && live_c ? to_f32(g_bh[q * g_q]) : 0.f;
      }
    };
    float2 cl;
    float cw, cg[4];
    load_block(0, cl, cw, cg);
    for (int k0 = 0; k0 < total; k0 += 4) {
      float2 nl;
      float nw, ng[4];
      load_block(k0 + 4, nl, nw, ng);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + i >= total) break;
        const int src = 8 * i + pt;
        const float2 l = make_float2(__shfl_sync(0xffffffffu, cl.x, src),
                                     __shfl_sync(0xffffffffu, cl.y, src));
        const float aw = __shfl_sync(0xffffffffu, cw, src);
        const float gq = cg[i];
        const int p = ((k0 + i) % steps) * kPointsPerStep + pt;

        // this lane's tap, merged with the step's other taps of its row:
        // the lowest such lane sums their weights in lane order and keeps
        // the row, so the step's rows are distinct
        const Tap t = make_tap(l, fW, fH, W, lane, p < P);
        const float wt = aw * t.wy * t.wx;
        const unsigned peers =
            __match_any_sync(0xffffffffu, t.ok ? t.row : -1 - lane);
        unsigned others = peers & ~(1u << lane);
        float wsum = wt;
        while (__any_sync(0xffffffffu, others != 0)) {
          const int k = others != 0 ? __ffs(others) - 1 : lane;
          const float wk = __shfl_sync(0xffffffffu, wt, k);
          if (others != 0) {
            wsum += wk;
            others &= others - 1;
          }
        }
        const bool lead = t.ok && (peers & below) == 0;
        const unsigned mask = __ballot_sync(0xffffffffu, lead);
        if (lead)
          list[__popc(mask & below)] =
              make_int2(t.row * kSlice * 4, __float_as_int(wsum));
        __syncwarp();
        const int n = __popc(mask);
        // The step's rows are distinct, so in each chunk of 8 taps every
        // read goes before every write; a chunk's taps come in 4
        // broadcast reads of two entries each.
#pragma unroll
        for (int j0 = 0; j0 < 32; j0 += 8) {
          if (j0 < n) {
            int off[8];
            float wj[8], a[8];
#pragma unroll
            for (int j = 0; j < 8; j += 2) {
              const int4 e = list4[(j0 + j) >> 1];
              off[j] = e.x;
              wj[j] = __int_as_float(e.y);
              off[j + 1] = e.z;
              wj[j + 1] = __int_as_float(e.w);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j0 + j < n)
                a[j] = *reinterpret_cast<const float*>(mine + off[j]);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j0 + j < n)
                *reinterpret_cast<float*>(mine + off[j]) =
                    fmaf(wj[j], gq, a[j]);
          }
        }
        __syncwarp();  // the list is rewritten next step
      }
      cl = nl;
      cw = nw;
#pragma unroll
      for (int i = 0; i < 4; ++i) cg[i] = ng[i];
    }
  }
  T* dv = static_cast<T*>(prm.dvalue) +
          (static_cast<size_t>(b) * hw * heads + h) * d + c0;
  if (qsplit == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += kThreads) {
      const int r = i / kSlice;
      const int c = i - r * kSlice;
      float sum = acc[i];
      for (int k = 1; k < walkers; ++k) sum += acc[k * tile + i];
      if (c0 + c < d)
        store_val(dv + static_cast<size_t>(r) * heads * d + c, sum);
    }
    return;
  }
  cluster_sync();  // every copy of the cluster is complete
  const int r0 = rank * hw / qsplit;
  const int r1 = (rank + 1) * hw / qsplit;
  for (int i = r0 * kSlice + threadIdx.x; i < r1 * kSlice; i += kThreads) {
    const int r = i / kSlice;
    const int c = i - r * kSlice;
    float sum = 0.f;
    for (int src = 0; src < qsplit; ++src)
      for (int k = 0; k < walkers; ++k)
        sum += ld_cluster(acc + k * tile + i, src);
    if (c0 + c < d)
      store_val(dv + static_cast<size_t>(r) * heads * d + c, sum);
  }
  cluster_sync();  // no CTA leaves while another reads its copies
}

// A sums CTA: dw and dloc of queries [q0, q1) of (b, h).
template <typename T, int KC>
__device__ __forceinline__ void sums_cta(const CUtensorMap& vmap,
                                         const BwdParams& prm,
                                         unsigned char* smem, int item) {
  constexpr int kN = LaneVals<T>::kN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int heads = prm.heads, d = prm.d, nq = prm.nq, P = prm.P;
  const int H = prm.H, W = prm.W;
  const int hw = H * W;
  const int pair = item / prm.chunks;
  const int b = pair / heads;
  const int h = pair - b * heads;
  const int q0 = (item - pair * prm.chunks) * prm.chunk;
  const int q1 = min(nq, q0 + prm.chunk);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* tile = reinterpret_cast<T*>(smem + kBarrierBytes);
  int* list = reinterpret_cast<int*>(smem + kBarrierBytes + prm.tile_bytes) +
              warp * 32;

  // stage V[b, :, h, :]
  if (prm.tma) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, static_cast<uint32_t>(hw * d * sizeof(T)));
      tma_load_4d(tile, &vmap, 0, h, 0, b * H, bar);
    }
  } else {
    const T* src = static_cast<const T*>(prm.value) +
                   (static_cast<size_t>(b) * hw * heads + h) * d;
    const size_t src_row = static_cast<size_t>(heads) * d;
    const int rs = prm.row_stride;
    for (int i = threadIdx.x; i < hw * rs; i += kThreads) {
      const int r = i / rs;
      const int c = i - r * rs;
      if (c < d)
        tile[i] = src[r * src_row + c];
      else
        store_val(tile + i, 0.f);  // the padding of an odd bf16 row
    }
    __syncthreads();
  }

  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(H);
  const int steps = max(1, (P + kPointsPerStep - 1) / kPointsPerStep);
  const int pt = lane >> 2;
  const unsigned below = (1u << lane) - 1u;
  const int q_stride = heads * P;
  const size_t qh0 = (static_cast<size_t>(b) * nq * heads + h) * P;
  const float2* loc_bh = reinterpret_cast<const float2*>(prm.loc) + qh0;
  const float* w_bh = prm.weight + qh0;
  const T* g_bh = static_cast<const T*>(prm.grad_out) +
                  (static_cast<size_t>(b) * nq * heads + h) * d;
  const size_t g_q = static_cast<size_t>(heads) * d;
  const int row_bytes = prm.row_stride * static_cast<int>(sizeof(T));
  const T* vs = tile + lane * kN;
  // the lane's channels of load k are (lane + 32k) * kN + e; a load that
  // starts at or past d is not issued
  bool live_c[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) live_c[k] = (lane + 32 * k) * kN < d;
  auto load_g = [&](int q, float (&gv)[KC * kN]) {
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int c = (lane + 32 * k) * kN + e;
        gv[k * kN + e] = q < q1 && c < d ? to_f32(g_bh[q * g_q + c]) : 0.f;
      }
  };

  int q = q0 + warp, g = 0;
  float2 l;
  float aw;
  load_point(loc_bh, w_bh, q_stride, q, pt, q < q1 && pt < P, l, aw);
  float gv[KC * kN];
  load_g(q, gv);
  if (prm.tma) mbar_wait(bar, 0);

  while (q < q1) {
    int nq1 = q, ng = g + 1;
    if (ng == steps) {
      ng = 0;
      nq1 += kWarps;
    }
    float2 nl;
    float naw;
    const int np = ng * kPointsPerStep + pt;
    load_point(loc_bh, w_bh, q_stride, nq1, np, nq1 < q1 && np < P, nl, naw);
    float ngv[KC * kN];
    if (ng == 0) load_g(nq1, ngv);

    const int p = g * kPointsPerStep + pt;
    const Tap t = make_tap(l, fW, fH, W, lane, p < P);
    const unsigned mask = __ballot_sync(0xffffffffu, t.ok);
    const int pos = __popc(mask & below);
    if (t.ok) list[pos] = t.row * row_bytes;
    __syncwarp();
    const int n = __popc(mask);
    const int entry = list[lane];  // lane j holds tap j (stale past n)
    __syncwarp();                  // the list is rewritten next step

    // dot[j]: this lane's channels' share of D of packed tap j
    float dot[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) dot[j] = 0.f;
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      if (j < n) {
        int off[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          off[i] = __shfl_sync(0xffffffffu, entry, j + i);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j + i < n) {
            const T* row = row_at(vs, off[i]);
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              if (live_c[k]) {
                float v[kN];
                load_vals(row + 32 * kN * k, v);
#pragma unroll
                for (int e = 0; e < kN; ++e)
                  dot[j + i] = fmaf(gv[k * kN + e], v[e], dot[j + i]);
              }
            }
          }
        }
      }
    }

    reduce_scatter<16>(dot, lane);
    reduce_scatter<8>(dot, lane);
    reduce_scatter<4>(dot, lane);
    reduce_scatter<2>(dot, lane);
    reduce_scatter<1>(dot, lane);
    // lane j holds D of packed tap j; each tap's lane takes its own
    const float D = __shfl_sync(0xffffffffu, dot[0], pos);
    float sw = t.ok ? t.wy * t.wx * D : 0.f;
    float sx = t.ok ? ((lane & 1) ? t.wy : -t.wy) * D : 0.f;
    float sy = t.ok ? ((lane & 2) ? t.wx : -t.wx) * D : 0.f;
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sw += __shfl_xor_sync(0xffffffffu, sw, o);
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sy += __shfl_xor_sync(0xffffffffu, sy, o);
    }
    if ((lane & 3) == 0 && p < P) {
      const size_t o = qh0 + static_cast<size_t>(q) * q_stride + p;
      if (prm.dweight != nullptr) prm.dweight[o] = sw;
      if (prm.dloc != nullptr)
        reinterpret_cast<float2*>(prm.dloc)[o] =
            make_float2(aw * fW * sx, aw * fH * sy);
    }

    l = nl;
    aw = naw;
    if (ng == 0) {
#pragma unroll
      for (int k = 0; k < KC * kN; ++k) gv[k] = ngv[k];
    }
    q = nq1;
    g = ng;
  }
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads, 3)
    deform_attn_2d_backward_kernel(const __grid_constant__ CUtensorMap vmap,
                                   const BwdParams prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cta = static_cast<int>(blockIdx.x);
  if (cta < prm.value_ctas)
    value_cta<T>(prm, smem, cta);
  else if (cta - prm.value_ctas < prm.sum_ctas)
    sums_cta<T, KC>(vmap, prm, smem, cta - prm.value_ctas);
  // the rest pad the grid to a whole number of clusters
}

// Launches the kernel for prm; `bs` and `bf16` describe `prm.value` to the
// tensor-map encoder.
template <typename T, int KC>
cudaError_t launch(const BwdParams& prm, int bs, int bf16, int ctas,
                   int smem_bytes, cudaStream_t stream) {
  // A runtime call first: it makes the device's context current on this
  // thread (the backward runs on autograd's worker thread), which the
  // driver's tensor-map encoder needs and does not do itself.
  cudaError_t err = cudaFuncSetAttribute(
      deform_attn_2d_backward_kernel<T, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap vmap = {};
  if (prm.tma) {
    err = encode_value_map(&vmap, prm.value, bf16, bs, prm.H, prm.W,
                           prm.heads, prm.d);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = prm.qsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, deform_attn_2d_backward_kernel<T, KC>, vmap,
                           prm);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_f32(const BwdParams& prm, int bs, int kc, int ctas,
                       int smem, cudaStream_t st) {
  switch (kc) {
    case 1: return launch<float, 1>(prm, bs, 0, ctas, smem, st);
    case 2: return launch<float, 2>(prm, bs, 0, ctas, smem, st);
    case 3: return launch<float, 3>(prm, bs, 0, ctas, smem, st);
    case 4: return launch<float, 4>(prm, bs, 0, ctas, smem, st);
    case 5: return launch<float, 5>(prm, bs, 0, ctas, smem, st);
    case 6: return launch<float, 6>(prm, bs, 0, ctas, smem, st);
    case 7: return launch<float, 7>(prm, bs, 0, ctas, smem, st);
    case 8: return launch<float, 8>(prm, bs, 0, ctas, smem, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const BwdParams& prm, int bs, int kc, int ctas,
                        int smem, cudaStream_t st) {
  switch (kc) {
    case 1: return launch<__nv_bfloat16, 1>(prm, bs, 1, ctas, smem, st);
    case 2: return launch<__nv_bfloat16, 2>(prm, bs, 1, ctas, smem, st);
    case 3: return launch<__nv_bfloat16, 3>(prm, bs, 1, ctas, smem, st);
    case 4: return launch<__nv_bfloat16, 4>(prm, bs, 1, ctas, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  value (bs, H*W, heads, d) fp32 or
// bf16; loc (bs, nq, heads, 1, P, 2) fp32, 8-byte aligned; weight
// (bs, nq, heads, 1, P) fp32; grad_out (bs, nq, heads*d) in the value type;
// dvalue (bs, H*W, heads, d) in the value type, every element written here;
// dloc and dweight fp32 like loc and weight; any of the three may be null
// to skip it.  All contiguous, all on the current device.  value_ctas ..
// smem_bytes are the plan of ops/deform_cuda.plan_backward.  Returns
// cudaErrorInvalidValue for a plan or shape the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int deform_attn_2d_backward(
    const void* value, const void* loc, const void* weight,
    const void* grad_out, void* dvalue, void* dloc, void* dweight, int bs,
    int H, int W, int heads, int d, int nq, int P, int value_is_bf16,
    int value_ctas, int slices, int walkers, int qsplit, int chunk,
    int chunks, int ctas,
    int row_stride, int tile_bytes, int acc_bytes, int smem_bytes,
    void* stream) {
  const long long elt = value_is_bf16 ? 2 : 4;
  const int lane_vals = value_is_bf16 ? 2 : 1;
  if (bs < 1 || H < 1 || W < 1 || heads < 1 || nq < 1 || P < 1 || d < 1 ||
      d > kMaxHeadDim || ctas < 1 ||
      reinterpret_cast<uintptr_t>(loc) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(dloc) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(bs) * heads;
  const long long hw = static_cast<long long>(H) * W;
  const bool want_v = dvalue != nullptr;
  const bool want_s = dloc != nullptr || dweight != nullptr;
  const long long used = value_ctas + pairs * chunks;
  if (slices != (d + kSlice - 1) / kSlice || qsplit < 1 || qsplit > 8 ||
      value_ctas != (want_v ? pairs * slices * qsplit : 0) ||
      ctas % qsplit != 0 || ctas < used || ctas - used >= qsplit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (want_s ? (chunk < 1 || chunks < 1 ||
                static_cast<long long>(chunk) * chunks < nq ||
                static_cast<long long>(chunk) * (chunks - 1) >= nq ||
                row_stride < d || (row_stride * elt) % 4 != 0 ||
                tile_bytes % 128 != 0 || hw * row_stride * elt > tile_bytes ||
                kBarrierBytes + tile_bytes + kWarps * kSumListBytes >
                    static_cast<long long>(smem_bytes))
             : chunks != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (want_v && (walkers < 1 || walkers > kWarps || acc_bytes % 128 != 0 ||
                 hw * kSlice * 4 != acc_bytes ||
                 kBarrierBytes + static_cast<long long>(walkers) *
                                     (acc_bytes + kValueListBytes) >
                     static_cast<long long>(smem_bytes)))
    return static_cast<int>(cudaErrorInvalidValue);

  BwdParams prm;
  prm.value = value;
  prm.loc = static_cast<const float*>(loc);
  prm.weight = static_cast<const float*>(weight);
  prm.grad_out = grad_out;
  prm.dvalue = dvalue;
  prm.dloc = static_cast<float*>(dloc);
  prm.dweight = static_cast<float*>(dweight);
  prm.H = H;
  prm.W = W;
  prm.heads = heads;
  prm.d = d;
  prm.nq = nq;
  prm.P = P;
  prm.value_ctas = value_ctas;
  prm.slices = slices;
  prm.walkers = walkers;
  prm.qsplit = qsplit;
  prm.sum_ctas = static_cast<int>(pairs * chunks);
  prm.chunk = chunk;
  prm.chunks = chunks;
  prm.row_stride = row_stride;
  prm.tile_bytes = tile_bytes;
  prm.acc_bytes = acc_bytes;
  prm.tma = want_s &&
            tma_takes(value, d, static_cast<int>(elt), row_stride, H, W);
  const int kc = (d + 32 * lane_vals - 1) / (32 * lane_vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      value_is_bf16 ? launch_bf16(prm, bs, kc, ctas, smem_bytes, s)
                    : launch_f32(prm, bs, kc, ctas, smem_bytes, s);
  return static_cast<int>(err);
}
