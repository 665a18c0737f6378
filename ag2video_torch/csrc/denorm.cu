// Fused SPADE denormalization for Hopper (sm_90a): the whole eval chain of
// one SPADE norm in one pass over device memory.
//
// Replaces no TPU kernel: XLA fused this chain on the TPU by itself
// (ag2video_tpu/models/normalization.py, SPADE's `param_free_norm(x) *
// (1 + gamma) + beta`, and the leaky ReLU after norm_0 / norm_1 in
// models/spade.py). In eager PyTorch the chain is 9-10 launches, each a full
// pass over the activation (a cast, the subtraction, the multiply, a cast
// back, 1 + gamma over a sliced copy, the product, the sum, the leaky ReLU),
// about 48 bytes of traffic per element. For x (rows, C) and the norm's
// merged conditioning output gb (rows, 2C), gamma = gb[:, :C] and beta =
// gb[:, C:], it computes, in the tensors' type T (bf16 or fp32):
//
//   n = T((float(x) - mean[c]) * mul[c])     mul = rsqrt(running_var + eps)
//   a = T(1 + float(gamma))
//   p = T(float(n) * float(a))
//   y = T(float(p) + float(beta))
//   y = act ? (y > 0 ? y : T(float(y) * 0.2f)) : y
//
// Those are exactly the rounding points of the eager chain, so the output is
// bit-equal to it (ops/denorm.py's `denorm_plain`, the CPU path and the
// oracle). The arithmetic is written with __fsub_rn / __fmul_rn / __fadd_rn
// so that nvcc contracts nothing into an FMA, which rounds once where the
// chain rounds twice.
//
// What bounds it on an H100: bytes. It reads x, gamma and beta and writes y
// once, 4 * sizeof(T) bytes per element (8 in bf16); the (C,) mean and mul
// vectors stay in L1 / L2. At up_3's norm_0 in the B=16 cells (16 x 256^2 x
// 128, bf16) that is 1.07 GB, 0.32 ms at 3.35 TB/s. The design serves that
// bound: each thread takes 16 bytes of channels of one row (8 bf16, 4 fp32)
// with one 16-byte load of x, gamma and beta each (gamma and beta read in
// place from gb at row stride 2C, never sliced into copies) and one 16-byte
// store, and a grid-stride loop over (row, channel group) sized to the SMs
// (8 blocks of 256 threads each: full occupancy), so that the 8x8 levels at
// B = 1 are one short launch and the 256^2 levels no long tail. A C that is
// not a multiple of the vector width, or a misaligned tensor, takes the same
// loop one channel at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A value rounded to T and read back: the eager chain's store between ops.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, bool kAct>
__device__ __forceinline__ T denorm_one(T x, T gamma, T beta, float mean,
                                        float mul) {
  const float n = rounded<T>(__fmul_rn(__fsub_rn(to_f(x), mean), mul));
  const float a = rounded<T>(__fadd_rn(1.0f, to_f(gamma)));
  const float p = rounded<T>(__fmul_rn(n, a));
  const T y = from_f<T>(__fadd_rn(p, to_f(beta)));
  if (!kAct) return y;
  const float yf = to_f(y);
  return yf > 0.0f ? y : from_f<T>(__fmul_rn(yf, 0.2f));
}

// kVec values of T in one aligned load or store (16 bytes on the vector
// path, one value otherwise).
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T, int kVec, bool kAct>
__global__ void __launch_bounds__(kThreads)
    ag_denorm_kernel(const T* __restrict__ x, const T* __restrict__ gb,
                     const float* __restrict__ mean,
                     const float* __restrict__ mul, T* __restrict__ y,
                     unsigned int groups, unsigned int row_groups, int C) {
  // The stats are read 4 floats (16 bytes) at a time on the vector path.
  constexpr int kStat = kVec >= 4 ? 4 : 1;
  using P = Pack<T, kVec>;
  using S = Pack<float, kStat>;
  const unsigned int stride = gridDim.x * blockDim.x;
  for (unsigned int i = blockIdx.x * blockDim.x + threadIdx.x; i < groups;
       i += stride) {
    const unsigned int row = i / row_groups;
    const int c0 = static_cast<int>(i - row * row_groups) * kVec;
    const size_t g0 = static_cast<size_t>(row) * (2 * C) + c0;
    const size_t x0 = static_cast<size_t>(i) * kVec;
    const P xv = *reinterpret_cast<const P*>(x + x0);
    const P gv = *reinterpret_cast<const P*>(gb + g0);
    const P bv = *reinterpret_cast<const P*>(gb + g0 + C);
    float m[kVec], s[kVec];
#pragma unroll
    for (int k = 0; k < kVec; k += kStat) {
      const S ms = *reinterpret_cast<const S*>(mean + c0 + k);
      const S ss = *reinterpret_cast<const S*>(mul + c0 + k);
#pragma unroll
      for (int j = 0; j < kStat; ++j) {
        m[k + j] = ms.v[j];
        s[k + j] = ss.v[j];
      }
    }
    P out;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      out.v[k] = denorm_one<T, kAct>(xv.v[k], gv.v[k], bv.v[k], m[k], s[k]);
    }
    *reinterpret_cast<P*>(y + x0) = out;
  }
}

template <typename T, int kVec>
int launch(const void* x, const void* gb, const float* mean,
           const float* mul, void* y, long long rows, int C, int act,
           int device, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned int row_groups = static_cast<unsigned int>(C / kVec);
  const unsigned int groups =
      static_cast<unsigned int>(rows) * row_groups;
  const long long needed = (static_cast<long long>(groups) + kThreads - 1) /
                           kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned int blocks =
      static_cast<unsigned int>(needed < most ? needed : most);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gb);
  T* yt = static_cast<T*>(y);
  if (act) {
    ag_denorm_kernel<T, kVec, true><<<blocks, kThreads, 0, stream>>>(
        xt, gt, mean, mul, yt, groups, row_groups, C);
  } else {
    ag_denorm_kernel<T, kVec, false><<<blocks, kThreads, 0, stream>>>(
        xt, gt, mean, mul, yt, groups, row_groups, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (rows, C) and y (rows, C), gb (rows, 2C), all float32 (dtype 0) or
// bfloat16 (dtype 1); mean and mul (C,) float32. All contiguous, on CUDA
// device `device`; rows * C / vec below 2^31, rows > 0. vec 16 / sizeof(T)
// takes 16-byte loads and needs C % vec == 0 and every pointer 16-byte
// aligned; vec 1 takes any C. Launches on `stream`, with `device` made
// current for the launch and the caller's device restored after it;
// returns cudaGetLastError() after the launch.
int ag_denorm_forward(const void* x, const void* gb, const void* mean,
                      const void* mul, void* y, long long rows, int C,
                      int dtype, int vec, int act, int device, void* stream) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(mul);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(x, gb, m, r, y, rows, C, act, device, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(x, gb, m, r, y, rows, C, act, device, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(x, gb, m, r, y, rows, C, act, device, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(x, gb, m, r, y, rows, C, act, device, s);
  }
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // extern "C"
