// The occupancy MLP and the occupancy lattice in one pass, for Hopper
// (sm_90a).
//
// It replaces no TPU kernel: on the TPU, XLA fused this chain of the
// occupancy head (vln_ver_tpu/models/head.py, the occupancy branch) into
// its neighbours.  Eagerly in PyTorch it was some 40 launches a forward:
// each row of `occ_proj`'s bf16 output went through Dense(D) -> LayerNorm
// -> ReLU -> Dense(D) -> LayerNorm -> ReLU -> fp32 Dense(n), every step a
// pass over device memory (the LayerNorms in fp32, with a cast on either
// side), and then the (B, occ_z, 2 gy, 2 gx, n) logits lattice was written
// twice (the bias cells' logits expanded and cloned, the even cells copied
// in).  It computes, for every row r of x (D bf16 channels),
//
//   h1 = relu(bf16(LN1(bf16(x W1^T + b1))))       (bf16 products, fp32
//   h2 = relu(bf16(LN2(bf16(h1 W2^T + b2))))        accumulation, fp32
//   y  = fp32(h2) W3^T + b3                         statistics)
//
// with the eager path's rounding points: the Dense weights and biases are
// rounded to bf16 as they are loaded (as `.to(bf16)` does), the products
// accumulate in fp32 on the tensor cores and round to bf16 after the bias,
// where cuBLAS's epilogue rounds; the LayerNorm takes fp32 statistics over
// the D channels and its fp32 affine, then rounds to bf16; the last layer
// is IEEE fp32 FMA on the bf16 values (no TF32).  In lattice mode, x is
// (B, gy, gx, occ_z, D) over the gy x gx even grid, row r = ((b gy + y) gx
// + x) occ_z + z, and the row's logits go to cell (b, z, 2y, 2x) of the
// (B, occ_z, 2 gy, 2 gx, n) fp32 lattice, with the bias cell's logits of
// plane z (`bias_logits`, (occ_z, n), computed by this kernel in rows mode)
// at (2y, 2x + 1), (2y + 1, 2x) and (2y + 1, 2x + 1): every byte of the
// lattice is written once.  In rows mode, x is (rows, D) and out (rows, n).
//
// What bounds it, at the 36-view headline (B = 8: 1,008,000 rows of 128
// channels, n = 16): device memory reads the rows once, 258 MB, and
// writes the lattice once, 258 MB, about 0.154 ms at 3.35 TB/s; the
// products are 66 GFLOP of bf16 (0.07 ms at 989 TFLOP/s) and 4.1 GFLOP of
// fp32 (0.06 ms at 67 TFLOP/s).  So bytes bound it, and the design keeps
// every intermediate on the SM.
//
// Design.
//  1. One persistent block of 16 warps an SM.  The block rounds W1 and W2 to
//     bf16 into shared memory ([out][in], rows padded by 16 bytes so that
//     ldmatrix is free of bank conflicts), and keeps W3 in fp32, the
//     LayerNorms' affines and the biases beside them, for its life.
//  2. A warp takes a tile of 16 rows at a time, walking tiles with a
//     stride of the grid's warps; each tile arrives by cp.async into the
//     warp's own buffer while the warp computes the one before.
//  3. Layers 1 and 2 are mma.sync m16n8k16 (bf16 in, fp32 accumulators):
//     the warp holds its 16 rows x D outputs in registers, and a row's D
//     values sit on the four lanes of a quad, so the LayerNorm's sums are
//     two shuffles.  Layer 1's accumulator layout is layer 2's A operand,
//     packed to bf16 in registers with no trip through shared memory.
//  4. Layer 3 is fp32 FMA: each lane dots its 2 rows x D/4 channels with
//     W3 (laid out lane-major in shared memory, one 16-byte load for four
//     channels), four outputs at a time, and the quad sums the partials;
//     outputs go in groups of 16, one pass each.
//  D is a template parameter (every multiple of 16 up to 128 is built), so
//  that every loop over channels unrolls with no run-time bound and the
//  compiler can issue shared-memory loads well ahead of their use: with D
//  known only at run time, the guarded loops left each load's latency
//  exposed and the kernel ran at about half the speed.
//  5. The lane that owns a row's outputs j..j+3 writes them and the three
//     bias cells' beside them, 16 bytes each where n is a multiple of 4.
// Rows past the end load as zeros and are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;      // rows of a warp's tile (one m16 tile)
constexpr int kMaxD = 128;     // D: a multiple of 16, at most this
constexpr int kGroup = 16;     // outputs of one layer-3 pass
constexpr int kMaxN = 2 * kGroup;
constexpr int kPad = 8;        // bf16 elements of padding a smem row

struct Params {
  const __nv_bfloat16* x;
  const float *w1, *b1, *g1, *be1, *w2, *b2, *g2, *be2, *w3, *b3;
  const float* bias_logits;
  float* out;
  long long rows, tiles;
  int n, groups, lattice, gy, gx, oz;
  float eps;
};

// Shared memory of a block, in order: W1, W2 (bf16, D x (D + kPad)); W3
// (fp32, lane major: 4 runs of w3_stride, lane t's run holding for each
// output j its D / 4 channels nt*8 + 2t + e at nt*2 + e); b1, b2 (bf16
// values, D each); each LayerNorm's (gamma, gamma, beta, beta) of the
// channel pairs (2c, 2c + 1) (4 D / 2 each); b3 (16 groups); then two x
// tiles a warp (bf16, kRows x (D + kPad)).
__host__ __device__ constexpr int w3_stride(int d, int groups) {
  // groups * 16 * D / 4 is a multiple of 32 floats; +4 puts the four lanes
  // of a quad on four different 16-byte bank groups
  return groups * kGroup * d / 4 + 4;
}

__host__ __device__ constexpr size_t smem_bytes(int d, int groups) {
  return 2 * static_cast<size_t>(d) * (d + kPad) * 2 +
         4 * static_cast<size_t>(w3_stride(d, groups)) * 4 +
         (2 * static_cast<size_t>(d) + 4 * d + kGroup * groups) * 4 +
         static_cast<size_t>(kWarps) * 2 * kRows * (d + kPad) * 2;
}
// at D = 128 and n > 16, 228,544 bytes: within the 227 KiB a block may take
static_assert(smem_bytes(kMaxD, kMaxN / kGroup) <= 227 * 1024,
              "a block's shared memory exceeds 227 KiB");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// acc = A W^T for the warp's 16 rows: A (16 x D) in mma A fragments, one
// per 16-channel step; W (D x D, [out][in]) in shared memory at `w`.
// acc[nt] holds outputs nt*8 .. nt*8+7: c0, c1 row g, columns 2t, 2t+1;
// c2, c3 row g + 8.
template <int D>
__device__ __forceinline__ void dense_mma(float (&acc)[D / 8][4],
                                          const uint32_t (&a)[D / 16][4],
                                          uint32_t w, int lane) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // ldmatrix x4 over W rows n0 .. n0+15, channels k0 .. k0+15: matrices
  // (n lo, k lo), (n lo, k hi), (n hi, k lo), (n hi, k hi), so that regs
  // 0, 1 are n-tile 2p's B fragment and regs 2, 3 n-tile 2p+1's
  const int n_off = (lane & 7) + ((lane >> 4) << 3);
  const int k_off = ((lane >> 3) & 1) << 3;
  const uint32_t lane_base =
      w + static_cast<uint32_t>((n_off * (D + kPad) + k_off) * 2);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4(lane_base + (p * 16 * (D + kPad) + ks * 16) * 2, b);
      mma_bf16(acc[2 * p], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[ks], b[2], b[3]);
    }
  }
}

// relu(bf16(LN(bf16(acc + bias)))) over each row's D channels, the pair of
// columns (2t, 2t+1) of n-tile nt as one bf16x2: out[nt][0] row g,
// out[nt][1] row g + 8.  gb holds (gamma, gamma, beta, beta) a pair.
template <int D>
__device__ __forceinline__ void bias_norm_relu(
    float (&acc)[D / 8][4], uint32_t (&out)[D / 8][2], const float* bias,
    const float4* gb, float eps, int t) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
    const float2 r0 = __bfloat1622float2(
        __floats2bfloat162_rn(acc[nt][0] + bb.x, acc[nt][1] + bb.y));
    const float2 r1 = __bfloat1622float2(
        __floats2bfloat162_rn(acc[nt][2] + bb.x, acc[nt][3] + bb.y));
    acc[nt][0] = r0.x;
    acc[nt][1] = r0.y;
    acc[nt][2] = r1.x;
    acc[nt][3] = r1.y;
    s0 += r0.x + r0.y;
    s1 += r1.x + r1.y;
  }
  constexpr float kInvD = 1.f / static_cast<float>(D);
  const float mean0 = quad_sum(s0) * kInvD, mean1 = quad_sum(s1) * kInvD;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    float v;
    v = acc[nt][0] - mean0; q0 = fmaf(v, v, q0);
    v = acc[nt][1] - mean0; q0 = fmaf(v, v, q0);
    v = acc[nt][2] - mean1; q1 = fmaf(v, v, q1);
    v = acc[nt][3] - mean1; q1 = fmaf(v, v, q1);
  }
  const float rstd0 = rsqrtf(quad_sum(q0) * kInvD + eps);
  const float rstd1 = rsqrtf(quad_sum(q1) * kInvD + eps);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const float4 w = gb[nt * 4 + t];
    out[nt][0] = as_u32(__hmax2(
        __floats2bfloat162_rn(w.x * (rstd0 * (acc[nt][0] - mean0)) + w.z,
                              w.y * (rstd0 * (acc[nt][1] - mean0)) + w.w),
        zero));
    out[nt][1] = as_u32(__hmax2(
        __floats2bfloat162_rn(w.x * (rstd1 * (acc[nt][2] - mean1)) + w.z,
                              w.y * (rstd1 * (acc[nt][3] - mean1)) + w.w),
        zero));
  }
}

// four consecutive outputs of one cell (fewer at the end of a row of n)
__device__ __forceinline__ void store4(float* dst, const float (&v)[4],
                                       int count, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < count) dst[e] = v[e];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    occ_mlp_kernel(const Params p) {
  constexpr int LD = D + kPad, kSteps = D / 16, kTilesN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, groups = p.groups, w3s_stride = w3_stride(D, groups);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w2s = w1s + D * LD;
  float* w3s = reinterpret_cast<float*>(w2s + D * LD);
  float* b1s = w3s + 4 * w3s_stride;
  float* b2s = b1s + D;
  float4* gb1s = reinterpret_cast<float4*>(b2s + D);
  float4* gb2s = gb1s + D / 2;
  float* b3s = reinterpret_cast<float*>(gb2s + D / 2);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(b3s + kGroup * groups);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* xw = xs + warp * 2 * kRows * LD;

  // a tile's 16 rows into buffer `buf` of this warp: 16-byte chunks, rows
  // past the end zero-filled
  auto load_tile = [&](long long tile, int buf) {
    constexpr int kChunks = D / 8;
    const long long row0 = tile * kRows;
    const uint32_t dst0 = smem_u32(xw + buf * kRows * LD);
#pragma unroll
    for (int k = 0; k < kRows * kChunks / 32; ++k) {
      const int i = lane + 32 * k, r = i / kChunks, c = i % kChunks;
      const bool in = row0 + r < p.rows;
      const __nv_bfloat16* src = in ? p.x + (row0 + r) * D + c * 8 : p.x;
      cp_async16(dst0 + (r * LD + c * 8) * 2, src, in ? 16 : 0);
    }
  };

  long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long tile_step = static_cast<long long>(gridDim.x) * kWarps;
  if (tile < p.tiles) load_tile(tile, 0);
  cp_async_commit();

  // the weights, for the block's life
  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    const int r = i / D, c = i % D;
    w1s[r * LD + c] = __float2bfloat16_rn(__ldg(p.w1 + i));
    w2s[r * LD + c] = __float2bfloat16_rn(__ldg(p.w2 + i));
  }
  for (int i = threadIdx.x; i < kGroup * groups * D; i += kThreads) {
    const int j = i / D, c = i % D;
    const int lt = (c & 7) >> 1, li = (c >> 3) * 2 + (c & 1);
    w3s[lt * w3s_stride + j * (D / 4) + li] = j < n ? __ldg(p.w3 + i) : 0.f;
  }
  for (int i = threadIdx.x; i < D; i += kThreads) {
    b1s[i] = __bfloat162float(__float2bfloat16_rn(__ldg(p.b1 + i)));
    b2s[i] = __bfloat162float(__float2bfloat16_rn(__ldg(p.b2 + i)));
  }
  for (int i = threadIdx.x; i < D / 2; i += kThreads) {
    gb1s[i] = make_float4(__ldg(p.g1 + 2 * i), __ldg(p.g1 + 2 * i + 1),
                          __ldg(p.be1 + 2 * i), __ldg(p.be1 + 2 * i + 1));
    gb2s[i] = make_float4(__ldg(p.g2 + 2 * i), __ldg(p.g2 + 2 * i + 1),
                          __ldg(p.be2 + 2 * i), __ldg(p.be2 + 2 * i + 1));
  }
  for (int i = threadIdx.x; i < kGroup * groups; i += kThreads)
    b3s[i] = i < n ? __ldg(p.b3 + i) : 0.f;
  __syncthreads();

  const uint32_t w1a = smem_u32(w1s), w2a = smem_u32(w2s);
  const float* w3t = w3s + t * w3s_stride;
  const bool vec4 = (n & 3) == 0;
  int buf = 0;
  for (; tile < p.tiles; tile += tile_step) {
    if (tile + tile_step < p.tiles) load_tile(tile + tile_step, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncwarp();

    // layer 1: A from the tile by ldmatrix (rows l % 16, channels
    // (l / 16) * 8 of each 16-channel step)
    uint32_t a[kSteps][4];
    const uint32_t xa = smem_u32(xw + buf * kRows * LD) +
                        ((lane & 15) * LD + ((lane >> 4) << 3)) * 2;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) ldmatrix_x4(xa + ks * 32, a[ks]);
    __syncwarp();   // the buffer is free for the next iteration's prefetch

    float acc[kTilesN][4];
    uint32_t h[kTilesN][2];
    dense_mma<D>(acc, a, w1a, lane);
    bias_norm_relu<D>(acc, h, b1s, gb1s, p.eps, t);
    // layer 2: its A fragments are layer 1's outputs, two n-tiles a
    // 16-channel step
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      a[ks][0] = h[2 * ks][0];
      a[ks][1] = h[2 * ks][1];
      a[ks][2] = h[2 * ks + 1][0];
      a[ks][3] = h[2 * ks + 1][1];
    }
    dense_mma<D>(acc, a, w2a, lane);
    bias_norm_relu<D>(acc, h, b2s, gb2s, p.eps, t);
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
      const float2 r0 = __bfloat1622float2(as_bf162(h[nt][0]));
      const float2 r1 = __bfloat1622float2(as_bf162(h[nt][1]));
      acc[nt][0] = r0.x;
      acc[nt][1] = r0.y;
      acc[nt][2] = r1.x;
      acc[nt][3] = r1.y;
    }

    // layer 3 in fp32, 16 outputs a pass: lane t keeps the sums of
    // outputs 4t .. 4t+3 of the pass, for row g (res[0]) and g + 8
    for (int grp = 0; grp < groups; ++grp) {
      float res[2][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s[2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* wr = w3t + (grp * kGroup + 4 * c + jj) * (D / 4);
          s[0][jj] = 0.f;
          s[1][jj] = 0.f;
#pragma unroll
          for (int q = 0; q < D / 16; ++q) {
            const float4 w = *reinterpret_cast<const float4*>(wr + 4 * q);
            s[0][jj] = fmaf(acc[2 * q][0], w.x, s[0][jj]);
            s[0][jj] = fmaf(acc[2 * q][1], w.y, s[0][jj]);
            s[0][jj] = fmaf(acc[2 * q + 1][0], w.z, s[0][jj]);
            s[0][jj] = fmaf(acc[2 * q + 1][1], w.w, s[0][jj]);
            s[1][jj] = fmaf(acc[2 * q][2], w.x, s[1][jj]);
            s[1][jj] = fmaf(acc[2 * q][3], w.y, s[1][jj]);
            s[1][jj] = fmaf(acc[2 * q + 1][2], w.z, s[1][jj]);
            s[1][jj] = fmaf(acc[2 * q + 1][3], w.w, s[1][jj]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float v =
                quad_sum(s[r][jj]) + b3s[grp * kGroup + 4 * c + jj];
            if (c == t) res[r][jj] = v;
          }
      }

      // the stores: rows g and g + 8 of the tile, outputs j0 .. j0+3
      const int j0 = grp * kGroup + 4 * t;
      if (j0 >= n) continue;
      const int count = min(4, n - j0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = tile * kRows + g + 8 * r;
        if (row >= p.rows) continue;
        if (!p.lattice) {
          store4(p.out + row * n + j0, res[r], count, vec4);
          continue;
        }
        // rows < 2^31 (the entry point checks), so 32-bit division
        const int row32 = static_cast<int>(row);
        const int cell = row32 / p.oz, z = row32 - cell * p.oz;
        const int rest = cell / p.gx, x = cell - rest * p.gx;
        const int b = rest / p.gy, y = rest - b * p.gy;
        const long long width = 2LL * p.gx;
        float* dst = p.out +
                     ((static_cast<long long>(b * p.oz + z) * 2 * p.gy +
                       2 * y) * width + 2 * x) * n + j0;
        float bl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bl[e] = e < count ? __ldg(p.bias_logits + z * n + j0 + e) : 0.f;
        store4(dst, res[r], count, vec4);
        store4(dst + n, bl, count, vec4);
        store4(dst + width * n, bl, count, vec4);
        store4(dst + width * n + n, bl, count, vec4);
      }
    }
    buf ^= 1;
  }
}

template <int D>
cudaError_t launch(const Params& prm, int blocks, cudaStream_t st) {
  const size_t smem = smem_bytes(D, prm.groups);
  cudaError_t err = cudaFuncSetAttribute(
      occ_mlp_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  occ_mlp_kernel<D><<<blocks, kThreads, smem, st>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  x bf16 rows of d channels,
// 16-byte aligned: (rows, d), or in lattice mode (B, gy, gx, oz, d), the
// even grid gy x gx, with rows = B gy gx oz; w1, w2 (d, d), b1, g1, be1,
// b2, g2, be2 (d), w3 (n, d), b3 (n), all fp32; bias_logits (oz, n) fp32
// (lattice mode only); out fp32, (rows, n) or (B, oz, 2 gy, 2 gx, n),
// 16-byte aligned where n is a multiple of 4.  All contiguous, all on the
// current device.  d a multiple of 16 up to 128, n from 1 to 32, rows below
// 2^31; blocks the grid (ops/occ_mlp.plan_grid).  Returns
// cudaErrorInvalidValue for a shape or pointer the kernel does not take,
// else cudaGetLastError() after the launch.
extern "C" int occ_mlp_forward(const void* x, const void* w1, const void* b1,
                               const void* g1, const void* be1,
                               const void* w2, const void* b2,
                               const void* g2, const void* be2,
                               const void* w3, const void* b3,
                               const void* bias_logits, void* out,
                               long long rows, int d, int n, int lattice,
                               int gy, int gx, int oz, float eps, int blocks,
                               void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 16 || d > kMaxD || d % 16 != 0 ||
      n < 1 || n > kMaxN || blocks < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      ((n & 3) == 0 && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lattice && (gy < 1 || gx < 1 || oz < 1 || bias_logits == nullptr ||
                  rows % (static_cast<long long>(gy) * gx * oz) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.x = static_cast<const __nv_bfloat16*>(x);
  prm.w1 = static_cast<const float*>(w1);
  prm.b1 = static_cast<const float*>(b1);
  prm.g1 = static_cast<const float*>(g1);
  prm.be1 = static_cast<const float*>(be1);
  prm.w2 = static_cast<const float*>(w2);
  prm.b2 = static_cast<const float*>(b2);
  prm.g2 = static_cast<const float*>(g2);
  prm.be2 = static_cast<const float*>(be2);
  prm.w3 = static_cast<const float*>(w3);
  prm.b3 = static_cast<const float*>(b3);
  prm.bias_logits = static_cast<const float*>(bias_logits);
  prm.out = static_cast<float*>(out);
  prm.rows = rows;
  prm.tiles = (rows + kRows - 1) / kRows;
  prm.n = n;
  prm.groups = (n + kGroup - 1) / kGroup;
  prm.lattice = lattice ? 1 : 0;
  prm.gy = gy;
  prm.gx = gx;
  prm.oz = oz;
  prm.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d / 16) {
    case 1: err = launch<16>(prm, blocks, s); break;
    case 2: err = launch<32>(prm, blocks, s); break;
    case 3: err = launch<48>(prm, blocks, s); break;
    case 4: err = launch<64>(prm, blocks, s); break;
    case 5: err = launch<80>(prm, blocks, s); break;
    case 6: err = launch<96>(prm, blocks, s); break;
    case 7: err = launch<112>(prm, blocks, s); break;
    case 8: err = launch<128>(prm, blocks, s); break;
  }
  return static_cast<int>(err);
}
