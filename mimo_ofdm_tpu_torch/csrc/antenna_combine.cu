// Antenna combine of the planar transmitter over bf16 planes:
//
//     out[b, k] = sum_a H[b, a, k] * X[b, a, k]            (complex64 out)
//
// with H = hr + i hi (the channel) and X = fr + i fi (the fused chain's
// output), [B, n_ant, n_sc] bf16 planes each. It is the propagation step of
// models/link_planar.py::tx_propagate (reference/channel.py:74-89), which
// the distorted TX and every MCNC replica pass run. It replaces no TPU
// kernel: the JAX package leaves this sum to XLA, and eagerly it is nine
// launches over the planes (four products, a difference, a sum, two f32
// antenna sums and the complex pack), about 2.7 GB a pass at B = 512.
//
// Each term is the eager expression's, bit for bit: every product of two
// bf16 values in f32 rounded to bf16, the difference (or sum) of the two
// rounded products in f32 rounded to bf16, that term widened to f32 and
// added into an f32 sum. Only the order of the f32 antenna sum differs from
// torch's reduction.
//
// What bounds it on an H100 (SXM, 3.35 TB/s): bytes. A pass reads the four
// planes once, 8 B a point, and writes 8 B a subcarrier: 545 MB at
// [512, 64, 2048], 0.163 ms. The arithmetic, 6 bf16x2 operations and 4 f32
// additions a pair of points, is a few per cent of the issue slots that
// time leaves.
//
// What the design does about it:
//   * A thread owns one frame b and 8 consecutive subcarriers (VEC = 8): for
//     each antenna it makes one 16-byte load from each plane; a warp reads
//     512 contiguous bytes of a plane. Four antennas' loads (16 of 16 B) are
//     issued before their terms are summed, so enough bytes are in flight
//     to cover the device memory's latency. The sums stay in registers.
//     Planes whose rows are not 16-byte aligned, or whose n_sc is not a
//     multiple of 8, take VEC = 1 (one subcarrier and 2-byte loads a
//     thread; same arithmetic, same bits).
//   * The antenna sum has one fixed order, antenna 0 first, in one thread
//     from +0. So the result depends on the inputs alone: not on the batch,
//     VEC or the run (no atomics). Under 32768 threads (B * n_sc / 8: 128
//     frames at n_sc = 2048) this leaves the card part idle, but such a pass
//     takes microseconds, and rounds of so few frames are paced by the host.
//   * H may be shared by every frame (batch stride 0, the geometric planes
//     without the RX reroll): its reads then hit L2.
//   * Every rounding is explicit (.rn), so nothing is contracted into an FMA
//     across a rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // a block
constexpr int kUnroll = 4;      // antennas whose loads are issued together

// Two bf16 lanes at once, each rounded to nearest even: a * b, a + b, a - b.
// For bf16 operands each equals the f32 operation rounded to bf16, as
// torch's bf16 operations compute it: f32 holds 24 bits, at least 2 * 8 + 2,
// so rounding twice gives what rounding once does.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the low (lower address) and high bf16 lane of a word, widened to f32
__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// VEC consecutive bf16 values of one plane as bf16x2 words (VEC = 1: the
// value in the low lane of one word, the high lane zero and unused)
template <int VEC>
struct Chunk {
  static constexpr int kWords = VEC == 8 ? 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    if constexpr (VEC == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
};

// One antenna's terms H * X added into the f32 sums, rounded as the eager
// expression rounds them: re = bf16(bf16(hr fr) - bf16(hi fi)),
// im = bf16(bf16(hr fi) + bf16(hi fr)).
template <int VEC>
__device__ __forceinline__ void accumulate(float (&re)[VEC], float (&im)[VEC],
                                           const Chunk<VEC> (&v)[4]) {
  const Chunk<VEC>& hr = v[0];
  const Chunk<VEC>& hi = v[1];
  const Chunk<VEC>& fr = v[2];
  const Chunk<VEC>& fi = v[3];
#pragma unroll
  for (int k = 0; k < Chunk<VEC>::kWords; ++k) {
    const uint32_t tr = sub_bf16x2(mul_bf16x2(hr.w[k], fr.w[k]), mul_bf16x2(hi.w[k], fi.w[k]));
    const uint32_t ti = add_bf16x2(mul_bf16x2(hr.w[k], fi.w[k]), mul_bf16x2(hi.w[k], fr.w[k]));
    re[2 * k] = __fadd_rn(re[2 * k], lo_f32(tr));
    im[2 * k] = __fadd_rn(im[2 * k], lo_f32(ti));
    if constexpr (VEC == 8) {
      re[2 * k + 1] = __fadd_rn(re[2 * k + 1], hi_f32(tr));
      im[2 * k + 1] = __fadd_rn(im[2 * k + 1], hi_f32(ti));
    }
  }
}

struct Planes {
  const __nv_bfloat16* hr;
  const __nv_bfloat16* hi;
  const __nv_bfloat16* fr;
  const __nv_bfloat16* fi;
};

// The kernel: thread item = blockIdx.x * 128 + threadIdx.x owns frame
// item / (n_sc / VEC) and the VEC subcarriers from k0, and sums their terms
// over the antennas in order.
template <int VEC>
__global__ void __launch_bounds__(kThreads, 4)
    antenna_combine_kernel(Planes p, float2* __restrict__ out, int frames, int n_ant, int n_sc,
                           long long h_stride, long long x_stride) {
  const int chunks = n_sc / VEC;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= static_cast<long long>(frames) * chunks) return;
  const int b = static_cast<int>(item / chunks);
  const int k0 = static_cast<int>(item % chunks) * VEC;
  const __nv_bfloat16* hr = p.hr + static_cast<size_t>(b) * h_stride + k0;
  const __nv_bfloat16* hi = p.hi + static_cast<size_t>(b) * h_stride + k0;
  const __nv_bfloat16* fr = p.fr + static_cast<size_t>(b) * x_stride + k0;
  const __nv_bfloat16* fi = p.fi + static_cast<size_t>(b) * x_stride + k0;

  float re[VEC], im[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) re[j] = im[j] = 0.0f;
  int a = 0;
  for (; a + kUnroll <= n_ant; a += kUnroll) {
    Chunk<VEC> v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t step = static_cast<size_t>(a + u) * n_sc;
      v[u][0].load(hr + step);
      v[u][1].load(hi + step);
      v[u][2].load(fr + step);
      v[u][3].load(fi + step);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate<VEC>(re, im, v[u]);
  }
  for (; a < n_ant; ++a) {
    const size_t step = static_cast<size_t>(a) * n_sc;
    Chunk<VEC> v[4];
    v[0].load(hr + step);
    v[1].load(hi + step);
    v[2].load(fr + step);
    v[3].load(fi + step);
    accumulate<VEC>(re, im, v);
  }

  float2* o = out + static_cast<size_t>(b) * n_sc + k0;
  if constexpr (VEC == 8) {
    float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j)
      o4[j] = make_float4(re[2 * j], im[2 * j], re[2 * j + 1], im[2 * j + 1]);
  } else {
    o[0] = make_float2(re[0], im[0]);
  }
}

template <int VEC>
int launch(const Planes& p, float2* out, int frames, int n_ant, int n_sc, long long h_stride,
           long long x_stride, cudaStream_t stream) {
  const long long items = static_cast<long long>(frames) * (n_sc / VEC);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  antenna_combine_kernel<VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      p, out, frames, n_ant, n_sc, h_stride, x_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, antenna_combine_kernel<VEC>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, antenna_combine_kernel<VEC>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = blocks;
  return 0;
}

}  // namespace

// One launch on the current stream for `frames` frames: hr, hi, fr, fi are
// bf16 planes [frames, n_ant, n_sc] whose rows are contiguous (antenna
// stride n_sc, subcarrier stride 1), H's frames h_stride elements apart
// and X's x_stride (0: one plane shared by every frame); out is complex64
// [frames, n_sc]. vec = 8 needs n_sc % 8 == 0 and 16-byte aligned rows;
// vec = 1 takes any. Returns a CUDA error code (0 on success).
extern "C" int antenna_combine_launch(const void* hr, const void* hi, const void* fr,
                                      const void* fi, void* out, int frames, int n_ant,
                                      int n_sc, long long h_stride, long long x_stride, int vec,
                                      void* stream) {
  if (frames <= 0 || n_sc <= 0) return 0;
  if (n_ant < 0 || (vec != 1 && vec != 8) || n_sc % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes p{static_cast<const __nv_bfloat16*>(hr), static_cast<const __nv_bfloat16*>(hi),
                 static_cast<const __nv_bfloat16*>(fr), static_cast<const __nv_bfloat16*>(fi)};
  const auto fn = vec == 8 ? launch<8> : launch<1>;
  return fn(p, static_cast<float2*>(out), frames, n_ant, n_sc, h_stride, x_stride,
            static_cast<cudaStream_t>(stream));
}

// Resources of the vec = 8 or vec = 1 kernel, written to out[0..2]:
// registers a thread, local memory bytes a thread (non-zero when ptxas
// spills), resident blocks per SM. Returns a CUDA error code.
extern "C" int antenna_combine_attributes(int vec, int* out) {
  if (vec != 1 && vec != 8) return static_cast<int>(cudaErrorInvalidValue);
  return vec == 8 ? attributes<8>(out) : attributes<1>(out);
}
