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
// ax, ay their fractional parts and v_ij the tap (floor(y)+i, floor(x)+j),
// zero where it lies outside the map (tested in float, so a far-out
// location never wraps an int):
//
//   dV[b, tap, h, c]   += w * tapweight * g[c]
//   dw[b, q, h, p]      = sum_c g[c] * sample[c]
//   dloc_x[b, q, h, p]  = W * w * sum_c g[c] * ((1-ay)(v01-v00) + ay(v11-v10))
//   dloc_y[b, q, h, p]  = H * w * sum_c g[c] * ((1-ax)(v10-v00) + ax(v11-v01))
//
// which is what autograd gives for the plain version (ops/sampling.py).
//
// What bounds it, at the main-path shape with batch 1 (bs = 6 camera slots,
// 14 x 14 values, 8 heads x 96, 8 points, 900 queries, fp32): device memory,
// value 3.61 MB + loc 2.76 MB + w 1.38 MB + g 16.59 MB in and dV 3.61 MB +
// dloc 2.76 MB + dw 1.38 MB out = 32.1 MB, 9.6 us at 3.35 TB/s.  The dV
// scatter is 4 taps x 96 x 8 points x 900 x 8 heads x 6 slots = 133M adds
// when every tap lands inside the map.
//
// Design (a simple first version; ops/deform_cuda.plan_backward picks the
// grid, and the CPU tests check it):
//  - A CTA owns one (slot, head) pair and a chunk of its queries, 8 warps.
//    Its share of dV[b, :, h, :] (hw x d fp32, 75 KB at the main shape)
//    is accumulated in shared memory with shared-memory atomics, then
//    added to the fp32 dV workspace in device memory with one global
//    atomic per nonzero element.  The order of the adds is not fixed, so
//    dV is not bitwise reproducible.
//  - A warp takes one query at a time; lanes own channels lane + 32k (KC of
//    them, a compile-time count, so every per-channel value is a register).
//    Lane p loads point p's location and weight; each point is broadcast
//    by shuffle, every lane forms the four taps, reads its channels of the
//    taps inside the map (from device memory through L1: the tile is read
//    by every query of the pair), and the three channel sums for dw and
//    dloc are reduced across the warp by shuffles.
//  - A null dvalue, dloc or dweight pointer skips that output: without
//    dloc and dweight the value is never read.
// bf16 values are read as bf16 and accumulated in fp32; dloc and dw are
// fp32 like their inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKC = 8;  // 32 lanes x 8 channels: head_dim <= 256

struct BwdParams {
  const void* value;
  const float* loc;
  const float* weight;
  const void* grad_out;
  float* dvalue;   // fp32 workspace (bs, H*W, heads, d), zeroed; may be null
  float* dloc;     // (bs, nq, heads, 1, P, 2); may be null
  float* dweight;  // (bs, nq, heads, 1, P); may be null
  int H, W, heads, d, nq, P;
  int chunk, chunks;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int KC>
__device__ __forceinline__ void load_row(const T* vrow, int lane, int d,
                                         bool ok, float (&v)[KC]) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = lane + 32 * k;
    v[k] = (ok && c < d) ? to_f32(vrow[c]) : 0.f;
  }
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
    deform_attn_2d_backward_kernel(const BwdParams prm) {
  extern __shared__ __align__(16) float acc[];  // hw x d, when dV is wanted
  const int heads = prm.heads, d = prm.d, nq = prm.nq, P = prm.P;
  const int W = prm.W;
  const int hw = prm.H * W;
  const int pair = blockIdx.x / prm.chunks;
  const int b = pair / heads;
  const int h = pair - b * heads;
  const int q0 = (blockIdx.x - pair * prm.chunks) * prm.chunk;
  const int q1 = min(nq, q0 + prm.chunk);
  const bool want_v = prm.dvalue != nullptr;
  const bool want_s = prm.dloc != nullptr || prm.dweight != nullptr;
  const int tile = hw * d;

  if (want_v) {
    for (int i = threadIdx.x; i < tile; i += kThreads) acc[i] = 0.f;
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(prm.H);
  const T* value = static_cast<const T*>(prm.value);
  const T* grad_out = static_cast<const T*>(prm.grad_out);
  const float2* loc2 = reinterpret_cast<const float2*>(prm.loc);
  float2* dloc2 = reinterpret_cast<float2*>(prm.dloc);
  // row r of V[b, :, h, :] is at v_bh + r * heads * d
  const T* v_bh = value + (static_cast<size_t>(b) * hw * heads + h) * d;
  const size_t v_row = static_cast<size_t>(heads) * d;

  for (int q = q0 + warp; q < q1; q += kWarps) {
    const size_t qh = (static_cast<size_t>(b) * nq + q) * heads + h;
    float g[KC];
    load_row<T, KC>(grad_out + qh * d, lane, d, true, g);
    const float2* loc_q = loc2 + qh * P;
    const float* w_q = prm.weight + qh * P;

    for (int p0 = 0; p0 < P; p0 += 32) {
      const int np = min(32, P - p0);
      float2 my_loc = make_float2(0.f, 0.f);
      float my_w = 0.f;
      if (lane < np) {
        my_loc = __ldg(loc_q + p0 + lane);
        my_w = __ldg(w_q + p0 + lane);
      }
      float out_w = 0.f, out_x = 0.f, out_y = 0.f;
      for (int j = 0; j < np; ++j) {
        const float lx = __shfl_sync(0xffffffffu, my_loc.x, j);
        const float ly = __shfl_sync(0xffffffffu, my_loc.y, j);
        const float aw = __shfl_sync(0xffffffffu, my_w, j);
        // the plain version's arithmetic: a multiply, then a subtract
        const float x = __fsub_rn(__fmul_rn(lx, fW), 0.5f);
        const float y = __fsub_rn(__fmul_rn(ly, fH), 0.5f);
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        const float ax = x - x0;
        const float ay = y - y0;
        // bounds in float: a NaN fails them, a far-out value never wraps
        const bool okx0 = x0 >= 0.f && x0 <= fW - 1.f;
        const bool okx1 = x0 + 1.f >= 0.f && x0 + 1.f <= fW - 1.f;
        const bool oky0 = y0 >= 0.f && y0 <= fH - 1.f;
        const bool oky1 = y0 + 1.f >= 0.f && y0 + 1.f <= fH - 1.f;
        const bool ok00 = oky0 && okx0, ok01 = oky0 && okx1;
        const bool ok10 = oky1 && okx0, ok11 = oky1 && okx1;
        // the casts run only where the tap is in range
        const int ix0 = okx0 ? static_cast<int>(x0) : 0;
        const int ix1 = okx1 ? static_cast<int>(x0) + 1 : 0;
        const int iy0 = oky0 ? static_cast<int>(y0) : 0;
        const int iy1 = oky1 ? static_cast<int>(y0) + 1 : 0;
        const int r00 = iy0 * W + ix0, r01 = iy0 * W + ix1;
        const int r10 = iy1 * W + ix0, r11 = iy1 * W + ix1;

        if (want_s) {
          float v00[KC], v01[KC], v10[KC], v11[KC];
          load_row<T, KC>(v_bh + r00 * v_row, lane, d, ok00, v00);
          load_row<T, KC>(v_bh + r01 * v_row, lane, d, ok01, v01);
          load_row<T, KC>(v_bh + r10 * v_row, lane, d, ok10, v10);
          load_row<T, KC>(v_bh + r11 * v_row, lane, d, ok11, v11);
          float sw = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            const float top = (1.f - ax) * v00[k] + ax * v01[k];
            const float bot = (1.f - ax) * v10[k] + ax * v11[k];
            const float dxv =
                (1.f - ay) * (v01[k] - v00[k]) + ay * (v11[k] - v10[k]);
            const float dyv = bot - top;
            sw = fmaf(g[k], (1.f - ay) * top + ay * bot, sw);
            sx = fmaf(g[k], dxv, sx);
            sy = fmaf(g[k], dyv, sy);
          }
          sw = warp_sum(sw);
          sx = warp_sum(sx);
          sy = warp_sum(sy);
          if (lane == j) {
            out_w = sw;
            out_x = aw * fW * sx;
            out_y = aw * fH * sy;
          }
        }

        if (want_v) {
          const float w00 = aw * (1.f - ay) * (1.f - ax);
          const float w01 = aw * (1.f - ay) * ax;
          const float w10 = aw * ay * (1.f - ax);
          const float w11 = aw * ay * ax;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            const int c = lane + 32 * k;
            if (c < d) {
              if (ok00) atomicAdd(&acc[r00 * d + c], w00 * g[k]);
              if (ok01) atomicAdd(&acc[r01 * d + c], w01 * g[k]);
              if (ok10) atomicAdd(&acc[r10 * d + c], w10 * g[k]);
              if (ok11) atomicAdd(&acc[r11 * d + c], w11 * g[k]);
            }
          }
        }
      }
      if (want_s && lane < np) {
        const size_t o = qh * P + p0 + lane;
        if (prm.dweight != nullptr) prm.dweight[o] = out_w;
        if (dloc2 != nullptr) dloc2[o] = make_float2(out_x, out_y);
      }
    }
  }

  if (want_v) {
    __syncthreads();
    float* dv_bh = prm.dvalue + (static_cast<size_t>(b) * hw * heads + h) * d;
    for (int i = threadIdx.x; i < tile; i += kThreads) {
      const float v = acc[i];
      if (v != 0.f) {
        const int r = i / d;
        atomicAdd(dv_bh + r * v_row + (i - r * d), v);
      }
    }
  }
}

template <typename T, int KC>
cudaError_t launch(const BwdParams& prm, int ctas, int smem_bytes,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      deform_attn_2d_backward_kernel<T, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  deform_attn_2d_backward_kernel<T, KC>
      <<<ctas, kThreads, smem_bytes, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kc(const BwdParams& prm, int kc, int ctas, int smem,
                      cudaStream_t st) {
  switch (kc) {
    case 1: return launch<T, 1>(prm, ctas, smem, st);
    case 2: return launch<T, 2>(prm, ctas, smem, st);
    case 3: return launch<T, 3>(prm, ctas, smem, st);
    case 4: return launch<T, 4>(prm, ctas, smem, st);
    case 5: return launch<T, 5>(prm, ctas, smem, st);
    case 6: return launch<T, 6>(prm, ctas, smem, st);
    case 7: return launch<T, 7>(prm, ctas, smem, st);
    case 8: return launch<T, 8>(prm, ctas, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  value (bs, H*W, heads, d) fp32 or
// bf16; loc (bs, nq, heads, 1, P, 2) fp32, 8-byte aligned; weight
// (bs, nq, heads, 1, P) fp32; grad_out (bs, nq, heads*d) in the value type;
// dvalue an fp32 (bs, H*W, heads, d) workspace the caller zeroed, dloc and
// dweight fp32 like loc and weight; any of the three may be null to skip
// it.  All contiguous, all on the current device.  chunk, chunks, ctas and
// smem_bytes are the plan of ops/deform_cuda.plan_backward.  Returns
// cudaErrorInvalidValue for a plan or shape the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int deform_attn_2d_backward(
    const void* value, const void* loc, const void* weight,
    const void* grad_out, void* dvalue, void* dloc, void* dweight, int bs,
    int H, int W, int heads, int d, int nq, int P, int value_is_bf16,
    int chunk, int chunks, int ctas, int smem_bytes, void* stream) {
  if (bs < 1 || H < 1 || W < 1 || heads < 1 || nq < 1 || P < 1 || d < 1 ||
      d > 32 * kMaxKC || chunk < 1 || chunks < 1 ||
      static_cast<long long>(chunk) * chunks < nq ||
      static_cast<long long>(chunk) * (chunks - 1) >= nq ||
      static_cast<long long>(ctas) != static_cast<long long>(bs) * heads *
                                          chunks ||
      reinterpret_cast<uintptr_t>(loc) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(dloc) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile_bytes = 4LL * H * W * d;
  if (dvalue != nullptr ? smem_bytes < tile_bytes : smem_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);

  BwdParams prm;
  prm.value = value;
  prm.loc = static_cast<const float*>(loc);
  prm.weight = static_cast<const float*>(weight);
  prm.grad_out = grad_out;
  prm.dvalue = static_cast<float*>(dvalue);
  prm.dloc = static_cast<float*>(dloc);
  prm.dweight = static_cast<float*>(dweight);
  prm.H = H;
  prm.W = W;
  prm.heads = heads;
  prm.d = d;
  prm.nq = nq;
  prm.P = P;
  prm.chunk = chunk;
  prm.chunks = chunks;
  const int kc = (d + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      value_is_bf16 ? launch_kc<__nv_bfloat16>(prm, kc, ctas, smem_bytes, s)
                    : launch_kc<float>(prm, kc, ctas, smem_bytes, s);
  return static_cast<int>(err);
}
