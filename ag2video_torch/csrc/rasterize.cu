// Fused box rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ag2video_tpu/ops/pallas/rasterize_kernel.py
// (`_kernel`, entered through `boxes_to_layout_pallas` -> `_forward_impl`):
//
//   out[n, y, x, d] = sum_o vecs[n, o, d] * wy[n, o, y] * wx[n, o, x]
//   w(p) = clip(min(p + 1, 8 - p), 0, 1),  p = (c / (S - 1) - x0) / safe_w * 7
//   wx := 0 where the box has zero width/height or mask <= 0
//
// with the (N, O, H, W) coverage never written to memory.
//
// What bounds it on an H100: about 2*O flops per output element against 2
// bytes written per bf16 element (O = 11 on the dense generator path: ~11
// flop/byte, far under the card's ridge of ~295), so the output write
// bounds it and tensor cores buy nothing. The design therefore keeps every
// input byte out of the inner loop and streams the output with wide,
// coalesced stores:
//   * one block per (frame n, tile of BH rows, group of channel chunks);
//   * the frame's x-ramps (O x W) and the tile's y-ramps (O x BH) are built
//     once per block in shared memory;
//   * each thread owns VEC consecutive channels and keeps the first OREG
//     objects' vectors for them in registers (fp32), so the inner loop is
//     one broadcast shared load and VEC FMAs per object, then one VEC-wide
//     store; neighbouring threads own neighbouring channels, so a warp
//     writes one contiguous run of the (H, W, D) output;
//   * objects past OREG are read from global memory (L1/L2 resident),
//     which keeps any O correct; D and W need not be multiples of anything.
// Accumulation is fp32; the output is rounded once to the output dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;       // reference tile size (ops/rasterize.py TILE)
constexpr int kOReg = 16;      // objects whose vectors live in registers
constexpr int kVec = 4;        // channels per thread
constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 4;       // output rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_vec(float* p, const float (&a)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&a)[kVec]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Trapezoid ramp of one box edge pair at pixel-centre coordinate c in [0, 1].
__device__ __forceinline__ float ramp(float c, float lo, float extent) {
  const float p = (c - lo) / extent * static_cast<float>(kTile - 1);
  const float w = fminf(p + 1.0f, static_cast<float>(kTile) - p);
  return fminf(fmaxf(w, 0.0f), 1.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rasterize_kernel(const T* __restrict__ vecs, const float* __restrict__ boxes,
                 const float* __restrict__ mask, T* __restrict__ out, int O,
                 int D, int H, int W, int chunk_threads, int vec_io) {
  extern __shared__ float smem[];
  float* wx_s = smem;           // [O][W]
  float* wy_s = smem + O * W;   // [O][kRows]

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kRows;
  const int rows = min(kRows, H - y0);
  const float* bx = boxes + static_cast<size_t>(n) * O * 4;
  const float* mk = mask + static_cast<size_t>(n) * O;

  for (int i = threadIdx.x; i < O * W; i += blockDim.x) {
    const int o = i / W;
    const int x = i - o * W;
    const float bw = bx[o * 4 + 2];
    const float bh = bx[o * 4 + 3];
    const bool valid = (bw != 0.0f) && (bh != 0.0f) && (mk[o] > 0.0f);
    const float c = W > 1 ? static_cast<float>(x) / static_cast<float>(W - 1)
                          : 0.0f;
    wx_s[i] = valid ? ramp(c, bx[o * 4 + 0], bw == 0.0f ? 1.0f : bw) : 0.0f;
  }
  for (int i = threadIdx.x; i < O * kRows; i += blockDim.x) {
    const int o = i / kRows;
    const int y = y0 + (i - o * kRows);
    const float bh = bx[o * 4 + 3];
    const float c = H > 1 ? static_cast<float>(y) / static_cast<float>(H - 1)
                          : 0.0f;
    wy_s[i] = ramp(c, bx[o * 4 + 1], bh == 0.0f ? 1.0f : bh);
  }
  __syncthreads();

  const int tc = threadIdx.x % chunk_threads;
  const int xg = threadIdx.x / chunk_threads;
  const int x_groups = blockDim.x / chunk_threads;
  const int d0 = (blockIdx.x * chunk_threads + tc) * kVec;
  if (d0 >= D) return;
  const int nd = min(kVec, D - d0);

  const T* vn = vecs + static_cast<size_t>(n) * O * D;
  float v[kOReg][kVec];
#pragma unroll
  for (int o = 0; o < kOReg; ++o) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      v[o][k] = (o < O && k < nd)
                    ? to_f32(vn[static_cast<size_t>(o) * D + d0 + k])
                    : 0.0f;
    }
  }

  for (int r = 0; r < rows; ++r) {
    float cy[kOReg];
#pragma unroll
    for (int o = 0; o < kOReg; ++o) cy[o] = o < O ? wy_s[o * kRows + r] : 0.0f;
    T* orow = out + (static_cast<size_t>(n) * H + (y0 + r)) *
                        static_cast<size_t>(W) * D;

    for (int x = xg; x < W; x += x_groups) {
      float acc[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int o = 0; o < kOReg; ++o) {
        if (o < O) {
          const float cw = cy[o] * wx_s[o * W + x];
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[k] = fmaf(cw, v[o][k], acc[k]);
        }
      }
      for (int o = kOReg; o < O; ++o) {
        const float cw = wy_s[o * kRows + r] * wx_s[o * W + x];
        const T* vo = vn + static_cast<size_t>(o) * D + d0;
        for (int k = 0; k < nd; ++k) acc[k] = fmaf(cw, to_f32(vo[k]), acc[k]);
      }
      T* p = orow + static_cast<size_t>(x) * D + d0;
      if (vec_io && nd == kVec) {
        store_vec(p, acc);
      } else {
        for (int k = 0; k < nd; ++k) store1(p + k, acc[k]);
      }
    }
  }
}

template <typename T>
int launch(const void* vecs, const void* boxes, const void* mask, void* out,
           int N, int O, int D, int H, int W, cudaStream_t stream) {
  const int chunks = (D + kVec - 1) / kVec;
  int chunk_threads = ((chunks + 31) / 32) * 32;
  if (chunk_threads > kThreads) chunk_threads = kThreads;
  const dim3 grid((chunks + chunk_threads - 1) / chunk_threads,
                  (H + kRows - 1) / kRows, N);
  const size_t smem = static_cast<size_t>(O) * (W + kRows) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rasterize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec_io = (D % kVec) == 0;
  rasterize_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(vecs), static_cast<const float*>(boxes),
      static_cast<const float*>(mask), static_cast<T*>(out), O, D, H, W,
      chunk_threads, vec_io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for (O, W), so the caller can refuse a
// shape before launching.
long long ag_rasterize_smem_bytes(int O, int W) {
  return static_cast<long long>(O) * (W + kRows) * sizeof(float);
}

// vecs (N, O, D) in float32 (dtype 0) or bfloat16 (dtype 1); boxes (N, O, 4)
// float32 xywh; mask (N, O) float32; out (N, H, W, D) in the dtype of vecs.
// All contiguous. Returns cudaGetLastError() after the launch.
int ag_rasterize_forward(const void* vecs, const void* boxes, const void* mask,
                         void* out, int N, int O, int D, int H, int W,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(vecs, boxes, mask, out, N, O, D, H, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vecs, boxes, mask, out, N, O, D, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
