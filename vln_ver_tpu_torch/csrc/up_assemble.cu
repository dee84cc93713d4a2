// The refine_occ upsampler's even-grid assembly, for Hopper (sm_90a).
//
// It replaces no TPU kernel: on the TPU, XLA fused the z-tap sums, the
// parity-phase interleave and the bias profile of the JAX package's
// even-grid factorisation (vln_ver_tpu/models/head.py, _UpStage.phase_conv)
// into its neighbours.  Eagerly in PyTorch, between a stage's cuDNN
// convolutions, the three phases of asymmetric padding were padded once for
// each z-tap (a fill and a copy of the input each), the z-sliced inputs
// copied, each z-tap's output added into the k = 1 tap's in bf16, the four
// phases stacked twice and the bias profile added: some 5.4 ms of copies
// and adds a batch at the 36-view headline, for a few GB of bytes.
//
// Now the convolutions write their outputs where this kernel reads them
// (models/head.py, the z-major route): the activations are z-major,
// (Z, B, h, w, C), so each z-slice of a convolution's input is a leading
// slice; every phase runs with the symmetric padding of its larger side,
// so its output holds the wanted window at an offset.  For every cell
// (z, b, Y, X) of the stage's even grid, z-major and channels-last, the
// kernel computes
//
//   out = T(mid)[z] + T(low)[z - 2] + T(high)[z]           (phase's taps)
//       + (P(mid) + P(low) + P(high))                      (bias profile)
//
// summed in fp32 in that order and rounded once to the stage's type (bf16
// or fp32): T the z-tap outputs of the cell's parity phase (py, px) =
// (Y mod g, X mod g) at its window cell (Y / g + oy, X / g + ox), g the
// grid (1 at stage 1, 2 after); `low` (the k = 0 tap over planes 0..Z-3)
// only where z >= 2, `high` (the k = 2 tap over planes 2..Z-1) only where
// z <= Z - 3, neither at Z <= 2; P the profile's taps, batch-free (a
// stride of 0 for the plane and the batch), with the same z rule.  The
// plain version, ops/up_assemble.assemble_plain, sums in the same order,
// so the two agree bit for bit.
//
// What bounds it: bytes.  At the 36-view headline (bf16, Z = 4, C = 768,
// B = 8) the three stages read 464 MB of tap outputs and 21 MB of profiles
// and write 232 MB, about 0.21 ms at 3.35 TB/s; it does one add a value
// read.
//
// Design: a block of 256 threads a row (z, b, Y) of the output, each
// thread walking the row's 16-byte vectors (8 bf16 or 4 fp32 channels) with
// a stride of the block; a warp's 32 vectors lie in one cell where C is a
// multiple of 32 vectors, so its loads and stores are whole 512-byte runs.
// The sources' descriptors sit in shared memory, where a run-time phase
// index is free (an index into the kernel's parameters would copy them to
// local memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSources = 5;     // up to four phases, then the profile

// One convolution's z-tap outputs: tap[0] the k = 1 tap (every plane),
// tap[1] the k = 0 tap (plane j feeds plane j + 2), tap[2] the k = 2 tap
// (plane j feeds plane j); null where absent.  Element strides of a plane,
// a batch, a row and a column (0 where the source broadcasts); channels
// are contiguous.  (oy, ox) the offset of the window read.
struct Source {
  const void* tap[3];
  long long sz, sb, sy, sx;
  int oy, ox;
};

struct Params {
  Source src[kSources];
  void* out;
  int Z, B, Ho, Wo, C;
  int grid;        // 1: one phase; 2: four phases, (py, px) at 2 py + px
  int has_prof;    // src[kSources - 1] is the profile
};

template <typename T>
struct Vec;

// 8 bf16 channels; two floats rounded to nearest even and packed, lo in
// the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(float* v, const void* p) {
    const uint4 u = __ldg(static_cast<const uint4*>(p));
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
    v[4] = __uint_as_float(u.z << 16);
    v[5] = __uint_as_float(u.z & 0xffff0000u);
    v[6] = __uint_as_float(u.w << 16);
    v[7] = __uint_as_float(u.w & 0xffff0000u);
  }
  __device__ __forceinline__ static void store(void* p, const float* v) {
    *static_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
};

// 4 fp32 channels
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(float* v, const void* p) {
    const float4 u = __ldg(static_cast<const float4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ __forceinline__ static void store(void* p, const float* v) {
    *static_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// v = tap[0][off] (+ tap[1][off - 2 sz] where low) (+ tap[2][off] where
// high), in fp32, in that order
template <typename T>
__device__ __forceinline__ void zsum(float* v, const Source& s, long long off,
                                     bool low, bool high) {
  using V = Vec<T>;
  const T* const* tap = reinterpret_cast<const T* const*>(s.tap);
  V::load(v, tap[0] + off);
  float t[V::N];
  if (low && tap[1] != nullptr) {
    V::load(t, tap[1] + off - 2 * s.sz);
#pragma unroll
    for (int i = 0; i < V::N; ++i) v[i] += t[i];
  }
  if (high && tap[2] != nullptr) {
    V::load(t, tap[2] + off);
#pragma unroll
    for (int i = 0; i < V::N; ++i) v[i] += t[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) up_assemble_kernel(const Params p) {
  using V = Vec<T>;
  __shared__ Source src[kSources];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kSources; ++i) src[i] = p.src[i];
  }
  __syncthreads();
  const int row = blockIdx.x;    // (z B + b) Ho + Y
  const int Y = row % p.Ho, zb = row / p.Ho;
  const int b = zb % p.B, z = zb / p.B;
  const int py = Y % p.grid, t = Y / p.grid;
  const bool low = z >= 2, high = z + 2 < p.Z;
  const int cv = p.C / V::N;     // vectors a cell
  const int n = p.Wo * cv;
  T* out = static_cast<T*>(p.out) + static_cast<long long>(row) * p.Wo * p.C;
  const Source& P = src[kSources - 1];
  const long long prow = z * P.sz + b * P.sb +
                         static_cast<long long>(Y + P.oy) * P.sy;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int X = j / cv;
    const int c = (j - X * cv) * V::N;
    const int px = X % p.grid, s = X / p.grid;
    const Source& S = src[py * p.grid + px];
    const long long off = z * S.sz + b * S.sb +
                          static_cast<long long>(t + S.oy) * S.sy +
                          static_cast<long long>(s + S.ox) * S.sx + c;
    float v[V::N];
    zsum<T>(v, S, off, low, high);
    if (p.has_prof) {
      float q[V::N];
      zsum<T>(q, P, prow + static_cast<long long>(X + P.ox) * P.sx + c, low,
              high);
#pragma unroll
      for (int i = 0; i < V::N; ++i) v[i] += q[i];
    }
    V::store(out + static_cast<long long>(X) * p.C + c, v);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  taps: kSources x 3 pointers
// (each source's k = 1, k = 0 and k = 2 tap outputs, null where absent;
// the first grid^2 sources the phases, the last the profile where
// has_prof); strides: kSources x 4 element strides (plane, batch, row,
// column); offsets: kSources x 2 (oy, ox).  out (Z, B, Ho, Wo, C)
// contiguous.  Every tap of the stage's type (bf16 where bf16, else fp32),
// its channels contiguous and every vector 16-byte aligned, all on the
// current device; C a multiple of 16 bytes' worth of channels; Z B Ho
// below 2^31, Wo C below 2^31.  Returns cudaErrorInvalidValue for a shape
// or pointer the kernel does not take, else cudaGetLastError() after the
// launch.
extern "C" int up_assemble(const void* const* taps, const long long* strides,
                           const int* offsets, void* out, int Z, int B,
                           int Ho, int Wo, int C, int grid, int has_prof,
                           int bf16, void* stream) {
  const int vec = bf16 ? 8 : 4;
  const long long rows = static_cast<long long>(Z) * B * Ho;
  if (Z < 1 || B < 1 || Ho < 1 || Wo < 1 || C < vec || C % vec != 0 ||
      (grid != 1 && grid != 2) || rows > 0x7fffffffLL ||
      static_cast<long long>(Wo) * C > 0x7fffffffLL || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  const int phases = grid * grid;
  for (int i = 0; i < kSources; ++i) {
    Source& s = prm.src[i];
    const bool used = i < phases || (has_prof && i == kSources - 1);
    for (int k = 0; k < 3; ++k) {
      s.tap[k] = used ? taps[3 * i + k] : nullptr;
      if (s.tap[k] != nullptr &&
          reinterpret_cast<uintptr_t>(s.tap[k]) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (used && s.tap[0] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    s.sz = strides[4 * i];
    s.sb = strides[4 * i + 1];
    s.sy = strides[4 * i + 2];
    s.sx = strides[4 * i + 3];
    s.oy = offsets[2 * i];
    s.ox = offsets[2 * i + 1];
    if (used && (s.sz % vec || s.sb % vec || s.sy % vec || s.sx % vec))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.out = out;
  prm.Z = Z;
  prm.B = B;
  prm.Ho = Ho;
  prm.Wo = Wo;
  prm.C = C;
  prm.grid = grid;
  prm.has_prof = has_prof ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(rows);
  if (bf16)
    up_assemble_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(prm);
  else
    up_assemble_kernel<float><<<blocks, kThreads, 0, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
