// The eval forward of a factorized frontend conv for Hopper (sm_90a): the
// object-basis contraction, the dense image conv, the norm and the leaky ReLU
// of models/factorized.py's FactorizedNormConv in one launch.
//
// Replaces no TPU kernel: on the TPU the einsum ran on the matrix unit and
// XLA fused the image conv's add, the BatchNorm and the activation around it
// (ag2video_tpu/models/factorized.py). In eager PyTorch the chain is an
// unfold of the coverage maps to fp32, an fp32 `bmm` on CUDA cores, a cuDNN
// conv, and some ten elementwise and cast passes over the (B, H, W, F)
// output. At the B=16 256^2 frame (F = 512, nF*O = 22) that is ~20 ms.
//
// For one sample b, pixel (y, x) and feature f it computes, with K = nF*O
// coverage maps cov_k and the per-sample kernels wk (B, K, 9, F):
//
//   img = bf16(sum_{c,s} img[y+dy(s), x+dx(s), c] * wimg[f, c, s])   (1)
//   v   = img + sum_{k,s} cov_k[y+dy(s), x+dx(s)] * wk[b, k, s, f]   (2)
//   y   = bf16(v + shift[f])                                   bias
//   y   = bf16((float(bf16(v)) - mean[f]) * mul[f] + shift[f])    BatchNorm
//   y   = y > 0 ? y : bf16(float(y) * 0.2)                 leaky ReLU
//
// with 3x3 SAME shifts s (zeros outside the map), products of bf16 operands
// and fp32 sums, rounded where the eager chain rounds: (1) is cuDNN's bf16
// conv, (2) the fp32 `bmm` plus the fp32 add, the norm's steps are separate
// fp32 operations (__fsub_rn / __fmul_rn / __fadd_rn: nothing contracted
// into an FMA), mul = rsqrt(running_var + eps) * scale is the wrapper's. Only
// the order of the fp32 sums differs from the eager chain, so now and then
// one bf16 rounding of v flips (ops/objconv.py's `objconv_plain` is the
// oracle). In fp32 compute every bf16() above is the identity.
//
// Two paths, chosen by the entry point: bf16 with F a multiple of 32, K <=
// 56 and C <= 16 (the frame loop's convs) runs on the tensor cores, below;
// everything else (fp32 compute, other widths) on the CUDA cores
// (`ag_objconv_direct_kernel`, further down), so every eval call of the
// module on the card is this kernel's.
//
// What bounds it on an H100: bytes written. At the B=16 frame it reads 46 MB
// of coverage and 6 MB of image and writes 1.07 GB of bf16 output: 0.34 ms at
// 3.35 TB/s; its 241 GFLOP take 0.24 ms at the bf16 tensor-core peak. The
// design keeps the loads, the tensor cores and the stores busy at once:
//
// * Implicit im2col on wgmma (m64nNk16, bf16 operands read from shared
//   memory, fp32 accumulators). A tile is one row of 64 pixels and NT (128,
//   64 or 32) features; its coverage maps, with a halo of one row above and
//   below and 8 columns each side, sit in shared memory as planes of 8 maps,
//   [plane][row][col][8], 16 bytes a pixel. The reduction runs over halves of
//   k16 steps, 8 maps of a plane read at one of the 9 shifts: the A operand
//   of a half is the plane read from the shifted pixel, 64 consecutive
//   16-byte rows, a canonical K-major tile without swizzle whose descriptor
//   start moves with the shift. The 9x unfold never exists. The two halves
//   of a step are taken a row or a plane apart (pair_planes): halves 16 or
//   32 bytes apart overlap, and wgmma reads them at about half the rate.
//   The image (C <= 16 channels; C <= 4 packs pixels x and x + 1 into one
//   16-byte slot, 3 steps) is a second product over its own planes; its
//   fp32 sum is rounded to bf16 in the accumulators, which then take the
//   layout product on top.
// * Warp specialisation, one block of three warpgroups on each SM: warp s
//   of warpgroup 0 gathers the halo of every tile that stage s of a ring of
//   NS <= 4 holds, eight 16-byte loads of 8 pixels of 8 maps transposed in
//   registers into 8 pixels of 16 bytes, so that up to four tiles are in
//   flight from device memory. Two consumer warpgroups take the tiles in
//   turn: the products, then the norm and activation, then stores of 16
//   contiguous bytes from each lane (the four lanes of a pixel trade their
//   feature pairs by shuffles first). While one consumer runs its
//   epilogue, the other's products run; named barriers pass the stages.
// * Persistent blocks: each walks a contiguous run of (sample, feature block,
//   tile) items, so a sample's projected kernels (NT features x 9 * K, in
//   the order of the halves, [half][feature][8]: the canonical K-major B
//   operand) are loaded into shared memory once per run, not once per tile.
//
// What it reaches (H100 80GB HBM3): 1.2-1.4 ms at the B=16 conv_dim_in,
// about 4x its bound. Each of the three parts alone takes 0.4-0.75 ms (the
// products 0.75 with their wait for the rounded image sum, the epilogue and
// stores 0.40, the halo gathers about 0.6) and two consumer warpgroups
// overlap them only in part; PERF.md keeps the readings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroup = 128;
constexpr int kThreads = 3 * kWarpgroup;  // a producer and two consumers
constexpr int kTW = 64;                   // tile: one row of 64 pixels
// A halo row holds columns x0 - 8 .. x0 + 71 (10 aligned chunks of 8 pixels;
// the products read x0 - 1 .. x0 + 64, from column kLead on), at a stride of
// kRow pixels: rows and planes then start in other banks.
constexpr int kHW = kTW + 16;
constexpr int kChunks = kHW / 8;
constexpr int kLead = 7;
constexpr int kRow = kHW + 1;
constexpr int kPlane = 3 * kRow * 16;     // bytes of a plane of 8 maps
constexpr int kShifts = 9;                // 3x3
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;          // 227 KB a block
// Named barriers (0 is __syncthreads): a full and an empty barrier per
// stage, between its producer warp and the consumer warpgroup of its tile.
constexpr int kFull = 1;
constexpr int kEmpty = kFull + kMaxStages;
constexpr int kPair = kWarpgroup + 32;
// The reduction runs over halves of k16 steps: 8 maps (or channels) of one
// plane read at one shift, coded (plane << 4) | (dy << 2) | dx, or kPad
// (zero kernels). The two halves of a step sit >= 128 bytes apart where the
// planes allow it: wgmma reads two overlapping halves at a lower rate.
constexpr int kMaxMaps = 56;
constexpr int kMaxImgCh = 16;
constexpr int kMaxHalves = 9 * 7 + 1;     // kMaxMaps maps
constexpr int kMaxImgHalves = 9 * 2;      // kMaxImgCh channels
constexpr uint16_t kPad = 0xFFFF;

struct Params {
  const uint16_t* cov;   // (B, K, H, W) bf16, sample stride cov_bstride
  const uint16_t* wk;    // (B, K, 9, F) bf16
  const uint16_t* img;   // (B, H, W, C) bf16
  const uint16_t* wimg;  // (F, C, 3, 3) bf16
  const float* mean;     // (F,) (norm only)
  const float* mul;      // (F,) (norm only)
  const float* shift;    // (F,)
  uint16_t* out;         // (B, H, W, F) bf16
  long long cov_bstride;
  int B, K, H, W, F, C;
  int norm;
  int vec;     // the maps' rows are 16-byte aligned (W % 8 == 0 and so on)
  // Derived by the host.
  int J8;      // layout planes of 8 maps
  int JI;      // image planes: one packed, or C / 8 rounded up
  int packed;  // C <= 4: an image slot holds pixels x and x + 1 (4 + 4)
  int LH, IH;  // halves of the layout and the image products
  int NS;      // stages of the ring
  int tiles_w, tiles, n_blocks, items;
  uint16_t lay[kMaxHalves], im[kMaxImgHalves];
};

// Shared memory of one block, in bytes from the start.
template <int NT>
struct Layout {
  int w, wi, stat, stages, stage_bytes, total;

  __host__ __device__ Layout(const Params& p, int ns) {
    w = 0;
    wi = w + p.LH * NT * 16;
    stat = wi + p.IH * NT * 16;
    stages = (stat + 3 * NT * 4 + 127) / 128 * 128;
    stage_bytes = (p.J8 + p.JI) * kPlane;
    total = stages + ns * stage_bytes;
  }
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Writes by the threads (the generic proxy) made visible to wgmma's reads
// (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor without swizzle: 8 x 16-byte core
// matrices, `lbo` bytes apart along K, `sbo` bytes apart along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int NT>
__device__ __forceinline__ void wgmma(float (&d)[NT / 2], uint64_t da,
                                      uint64_t db, int acc) {
  if constexpr (NT == 128) {
    wgmma_n128(d, da, db, acc);
  } else if constexpr (NT == 64) {
    wgmma_n64(d, da, db, acc);
  } else {
    wgmma_n32(d, da, db, acc);
  }
}

// Offset in a stage of a half read from the planes from `plane0` on; a pad
// reads the first (finite, zero-weighted) pixels of those planes.
__device__ __forceinline__ uint32_t half_offset(int plane0, uint16_t h) {
  if (h == kPad) return (plane0 * 3 * kRow + kLead) * 16;
  const int pl = h >> 4, dy = (h >> 2) & 3, dx = h & 3;
  return ((plane0 + pl) * 3 * kRow + dy * kRow + kLead + dx) * 16;
}

// The projected kernels of sample b, features f0 .. f0 + NT, as B operands
// in the order of the halves: sW[h][n][q] = wk[b, 8 * plane + q, shift,
// f0 + n]; sWi[h][n][q] = wimg[f0 + n, 8 * plane + q, shift], or packed,
// q < 4 channel q at (dy, dx) and q >= 4 channel q - 4 at (dy, dx + 1); zero
// past K, C, the 3x3 window and at pads. Then the norm's vectors.
template <int NT>
__device__ void load_kernels(const Params& p, const Layout<NT>& lay,
                             unsigned char* smem, int b, int f0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < p.LH * NT; i += kThreads) {
    const int hi = i / NT, n = i - hi * NT;
    const uint16_t h = p.lay[hi];
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (h != kPad) {
      const int pl = h >> 4, s = ((h >> 2) & 3) * 3 + (h & 3);
      const uint16_t* src =
          p.wk + (static_cast<size_t>(b) * p.K * kShifts + s) * p.F + f0 + n;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = pl * 8 + q;
        if (j < p.K) {
          v[q >> 1] |= static_cast<uint32_t>(
                           src[static_cast<size_t>(j) * kShifts * p.F])
                       << ((q & 1) * 16);
        }
      }
    }
    *reinterpret_cast<uint4*>(smem + lay.w + i * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < p.IH * NT; i += kThreads) {
    const int hi = i / NT, n = i - hi * NT;
    const uint16_t h = p.im[hi];
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (h != kPad) {
      const int pl = h >> 4, dy = (h >> 2) & 3, dx = h & 3;
      const uint16_t* src = p.wimg + static_cast<size_t>(f0 + n) * p.C * 9;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        int c = pl * 8 + q, x = dx;
        if (p.packed) {
          c = q & 3;
          x = dx + (q >> 2);
        }
        if (c < p.C && x < 3) {
          v[q >> 1] |= static_cast<uint32_t>(src[c * 9 + dy * 3 + x])
                       << ((q & 1) * 16);
        }
      }
    }
    *reinterpret_cast<uint4*>(smem + lay.wi + i * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  float* st = reinterpret_cast<float*>(smem + lay.stat);
  for (int i = tid; i < NT; i += kThreads) {
    st[i] = p.norm ? p.mean[f0 + i] : 0.0f;
    st[NT + i] = p.norm ? p.mul[f0 + i] : 0.0f;
    st[2 * NT + i] = p.shift[f0 + i];
  }
}

// Component w of a 16-byte vector.
__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// The halo of the tile (b, row y, columns x0 .. x0 + 63) into one stage,
// by one warp: stage[plane][r][c][q] = cov[b, 8 * plane + q, y - 1 + r,
// x0 - 8 + c] for the J8 layout planes, then the image planes: img[b,
// y - 1 + r, x0 - 8 + c, 8 * plane' + q], or packed, channel q of x and q - 4
// of x + 1 (x = x0 - 8 + c); zero outside the map and past K and C.
__device__ void load_halo(const Params& p, unsigned char* stage, int b,
                          int y, int x0, int lane) {
  const int HW = p.H * p.W;
  const uint16_t* cb = p.cov + b * p.cov_bstride;
  if (p.vec) {
    // One item: 8 maps x 8 pixels, eight 16-byte loads (W % 8 == 0, so a
    // chunk lies wholly inside the map or outside it), transposed in
    // registers into eight 16-byte pixels. Neighbouring lanes take
    // neighbouring (plane, row)s, whose stores fall in different banks.
    const int rows = 3 * p.J8;
    for (int i = lane; i < rows * kChunks; i += 32) {
      const int ch = i / rows, pr = i - ch * rows;
      const int pl = pr / 3, r = pr - pl * 3;
      const int yy = y - 1 + r, xs = x0 - 8 + ch * 8;
      const bool in = yy >= 0 && yy < p.H && xs >= 0 && xs < p.W;
      const uint16_t* src = cb + (in ? yy * p.W + xs : 0);
      uint4 m[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = pl * 8 + q;
        m[q] = (in && j < p.K) ? *reinterpret_cast<const uint4*>(
                                     src + static_cast<size_t>(j) * HW)
                               : make_uint4(0u, 0u, 0u, 0u);
      }
      uint4* dst = reinterpret_cast<uint4*>(stage + pl * kPlane +
                                            (r * kRow + ch * 8) * 16);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const unsigned sel = (e & 1) ? 0x7632u : 0x5410u;
        uint32_t o[4];
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2) {
          o[q2] = __byte_perm(word(m[2 * q2], e >> 1),
                              word(m[2 * q2 + 1], e >> 1), sel);
        }
        dst[e] = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  // The image planes, and the layout planes where the maps are not
  // 16-byte aligned: pixel by pixel, over the columns the products read.
  const int first = p.vec ? p.J8 : 0;
  const int n = (p.J8 + p.JI - first) * 3 * (kTW + 2);
#pragma unroll 2
  for (int i = lane; i < n; i += 32) {
    const int pr = i / (kTW + 2), c = kLead + i - pr * (kTW + 2);
    const int pl = first + pr / 3, r = pr % 3;
    const int yy = y - 1 + r, xx = x0 - 8 + c;
    const bool row_in = yy >= 0 && yy < p.H;
    const bool in = row_in && xx >= 0 && xx < p.W;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (pl < p.J8) {
      const uint16_t* src = cb + (in ? yy * p.W + xx : 0);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = pl * 8 + q;
        if (in && j < p.K) {
          v[q >> 1] |= static_cast<uint32_t>(src[static_cast<size_t>(j) * HW])
                       << ((q & 1) * 16);
        }
      }
    } else {
      const uint16_t* src =
          p.img + (static_cast<size_t>(b) * HW + (row_in ? yy * p.W : 0)) * p.C;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        int c0 = (pl - p.J8) * 8 + q, x = xx;
        if (p.packed) {
          c0 = q & 3;
          x = xx + (q >> 2);
        }
        if (row_in && x >= 0 && x < p.W && c0 < p.C) {
          v[q >> 1] |= static_cast<uint32_t>(src[x * p.C + c0])
                       << ((q & 1) * 16);
        }
      }
    }
    *reinterpret_cast<uint4*>(stage + pl * kPlane + (r * kRow + c) * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Entry i (0 .. 3, a run-time index) of four registers.
__device__ __forceinline__ uint32_t pick(uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, int i) {
  const uint32_t lo = (i & 1) ? a1 : a0, hi = (i & 1) ? a3 : a2;
  return (i & 2) ? hi : lo;
}

// The epilogue of one consumer warpgroup: the norm (kNorm) or the bias,
// the leaky ReLU, bf16, stored to the tile's `valid` pixels of `orow`
// (the output at the tile's first pixel and feature f0). Accumulator i
// holds pixel 16 * warp + lane / 4 + 8 * ((i / 2) % 2), feature 8 * (i / 4)
// + 2 * (lane % 4) + i % 2; pairs of neighbouring features are rounded
// together. The four lanes of a pixel then trade their pairs (a 4 x 4
// transpose by three shuffles) so that each stores 16 contiguous bytes.
template <int NT, bool kNorm>
__device__ __forceinline__ void epilogue(const float (&d)[NT / 2],
                                         const float* st, uint16_t* orow,
                                         int valid, int F, int warp,
                                         int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int g = 0; g < NT / 32; ++g) {
    uint32_t o[4][2];  // features 8 * (4g + u) + 2 * t, + 1 of pixel h
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * g + u, f = 8 * j + 2 * t;
      const float2 sh = *reinterpret_cast<const float2*>(st + 2 * NT + f);
      float2 mn, ml;
      if (kNorm) {
        mn = *reinterpret_cast<const float2*>(st + f);
        ml = *reinterpret_cast<const float2*>(st + NT + f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        float2 r;
        if (kNorm) {
          const float2 x = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
          r.x = __fadd_rn(__fmul_rn(__fsub_rn(x.x, mn.x), ml.x), sh.x);
          r.y = __fadd_rn(__fmul_rn(__fsub_rn(x.y, mn.y), ml.y), sh.y);
        } else {
          r.x = __fadd_rn(v0, sh.x);
          r.y = __fadd_rn(v1, sh.y);
        }
        __nv_bfloat162 y = __floats2bfloat162_rn(r.x, r.y);
        const float2 yf = __bfloat1622float2(y);
        y = __floats2bfloat162_rn(yf.x > 0.0f ? yf.x : __fmul_rn(yf.x, 0.2f),
                                  yf.y > 0.0f ? yf.y : __fmul_rn(yf.y, 0.2f));
        o[u][h] = *reinterpret_cast<const uint32_t*>(&y);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Lane t holds its pair of blocks 4g + u; it gets block 4g + t:
      // lane v's pair of it, from lane v = t ^ r in round r.
      uint32_t got[4];
      got[0] = pick(o[0][h], o[1][h], o[2][h], o[3][h], t);
#pragma unroll
      for (int r = 1; r < 4; ++r) {
        got[r] = __shfl_xor_sync(
            0xffffffffu, pick(o[0][h], o[1][h], o[2][h], o[3][h], t ^ r), r);
      }
      const int px = 16 * warp + (lane >> 2) + 8 * h;
      if (px < valid) {
        *reinterpret_cast<uint4*>(orow + static_cast<size_t>(px) * F +
                                  8 * (4 * g + t)) =
            make_uint4(pick(got[0], got[1], got[2], got[3], t),
                       pick(got[0], got[1], got[2], got[3], t ^ 1),
                       pick(got[0], got[1], got[2], got[3], t ^ 2),
                       pick(got[0], got[1], got[2], got[3], t ^ 3));
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    ag_objconv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<NT> lay(p, p.NS);
  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup, lt = tid - wg * kWarpgroup;
  const int per = (p.items + gridDim.x - 1) / gridDim.x;
  const int begin = blockIdx.x * per;
  const int end = min(p.items, begin + per);
  const uint32_t stages = smem_u32(smem + lay.stages);
  const uint32_t w_lay = smem_u32(smem + lay.w);
  const uint32_t w_img = smem_u32(smem + lay.wi);
  const float* st = reinterpret_cast<const float*>(smem + lay.stat);

  int k = 0;  // tiles of this block so far: tile k uses stage k % NS
  int seg_end;
  for (int seg = begin; seg < end; seg = seg_end) {
    // A run of tiles of one (sample, feature block): one set of kernels.
    const int bn = seg / p.tiles;
    seg_end = min(end, (bn + 1) * p.tiles);
    const int b = bn / p.n_blocks, f0 = (bn - b * p.n_blocks) * NT;
    __syncthreads();  // every wgmma on the last kernels has completed
    load_kernels<NT>(p, lay, smem, b, f0);
    fence_proxy_async();
    __syncthreads();

    if (wg == 0) {
      // Producer warp w fills stage w: tile k while the consumers take
      // the tiles before it.
      const int w = lt >> 5;
      for (int it = seg; it < seg_end; ++it, ++k) {
        const int s = k % p.NS;
        if (s != w) continue;
        if (k >= p.NS) bar_sync(kEmpty + s, kPair);
        const int tile = it - bn * p.tiles;
        const int y = tile / p.tiles_w;
        load_halo(p, smem + lay.stages + s * lay.stage_bytes, b, y,
                  (tile - y * p.tiles_w) * kTW, lt & 31);
        fence_proxy_async();
        bar_arrive(kFull + s, kPair);
      }
      continue;
    }

    // Consumer warpgroup c takes the tiles k with k % 2 == c.
    const int c = wg - 1;
    const int warp = lt >> 5, lane = lt & 31;
    for (int it = seg; it < seg_end; ++it, ++k) {
      if ((k & 1) != c) continue;
      const int s = k % p.NS;
      const int tile = it - bn * p.tiles;
      const int y = tile / p.tiles_w, x0 = (tile - y * p.tiles_w) * kTW;
      const uint32_t base = stages + s * lay.stage_bytes;
      bar_sync(kFull + s, kPair);

      float d[NT / 2];  // written by the first product (scale-d 0)
      // (1) the image conv, rounded to bf16 where cuDNN rounds it.
      fence_acc(d);
      wgmma_fence();
#pragma unroll 1
      for (int t = 0; t < p.IH / 2; ++t) {
        const uint32_t a0 = base + half_offset(p.J8, p.im[2 * t]);
        const uint32_t a1 = base + half_offset(p.J8, p.im[2 * t + 1]);
        wgmma<NT>(d, make_desc(a0, a1 - a0, 128),
                  make_desc(w_img + 2 * t * NT * 16, NT * 16, 128), t > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) d[i] = bf(d[i]);
      fence_acc(d);
      // (2) the layout in the object basis, on top.
      wgmma_fence();
#pragma unroll 1
      for (int t = 0; t < p.LH / 2; ++t) {
        const uint32_t a0 = base + half_offset(0, p.lay[2 * t]);
        const uint32_t a1 = base + half_offset(0, p.lay[2 * t + 1]);
        wgmma<NT>(d, make_desc(a0, a1 - a0, 128),
                  make_desc(w_lay + 2 * t * NT * 16, NT * 16, 128), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
      bar_arrive(kEmpty + s, kPair);  // the stage is read

      uint16_t* orow = p.out +
                       ((static_cast<size_t>(b) * p.H + y) * p.W + x0) * p.F +
                       f0;
      const int valid = min(kTW, p.W - x0);
      if (p.norm) {
        epilogue<NT, true>(d, st, orow, valid, p.F, warp, lane);
      } else {
        epilogue<NT, false>(d, st, orow, valid, p.F, warp, lane);
      }
    }
  }
  // Each producer warp takes the consumers' last releases of its stage, so
  // that no barrier is left half-arrived.
  if (wg == 0) {
    for (int kk = k > p.NS ? k - p.NS : 0; kk < k; ++kk) {
      if (kk % p.NS == (lt >> 5)) bar_sync(kEmpty + kk % p.NS, kPair);
    }
  }
}

// The CUDA-core path, for what the tensor-core path does not take: fp32
// compute (T = float: the sums, the norm and the activation in fp32, no
// rounding between them, as the eager chain computes in fp32), or bf16
// with a feature count that is not a multiple of 32, more than 56 maps or
// more than 16 image channels (T = uint16_t, bf16 bits: rounded where the
// tensor-core path rounds). A block is 32 pixels of one row (the lanes) by
// 8 warps of kDF features each; a warp's lanes read the same kernels
// (broadcast) and neighbouring pixels of the maps. Not tuned: no benchmark
// cell runs it.
constexpr int kDF = 8;       // features a thread computes
constexpr int kDWarps = 8;   // warps a block

template <typename T>
__device__ __forceinline__ float load_f(const T* p, size_t i) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(reinterpret_cast<const float*>(p) + i);
  } else {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
    return __bfloat162float(__ushort_as_bfloat16(u));
  }
}

// Rounding to T's precision (none for fp32).
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return bf(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kDWarps)
    ag_objconv_direct_kernel(const Params p, const T* cov, const T* wk,
                             const T* img, const T* wimg, T* out) {
  const int tiles_w = (p.W + 31) / 32;
  const int tile = blockIdx.x;
  const int b = tile / (p.H * tiles_w);
  const int rest = tile - b * p.H * tiles_w;
  const int y = rest / tiles_w;
  const int x = (rest - y * tiles_w) * 32 + (threadIdx.x & 31);
  const int f0 = (blockIdx.y * kDWarps + (threadIdx.x >> 5)) * kDF;
  if (x >= p.W || f0 >= p.F) return;
  const int nf = min(kDF, p.F - f0);
  const size_t HW = static_cast<size_t>(p.H) * p.W;
  float acc[kDF];
#pragma unroll
  for (int j = 0; j < kDF; ++j) acc[j] = 0.0f;

  // (1) the image conv, rounded to T.
  for (int c = 0; c < p.C; ++c) {
#pragma unroll
    for (int s = 0; s < kShifts; ++s) {
      const int yy = y + s / 3 - 1, xx = x + s % 3 - 1;
      if (yy < 0 || yy >= p.H || xx < 0 || xx >= p.W) continue;
      const float v = load_f(img, ((b * HW + yy * static_cast<size_t>(p.W)
                                    + xx) * p.C) + c);
#pragma unroll
      for (int j = 0; j < kDF; ++j) {
        if (j < nf) {
          acc[j] = fmaf(v, load_f(wimg, (static_cast<size_t>(f0 + j) * p.C
                                         + c) * kShifts + s), acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDF; ++j) acc[j] = round_t<T>(acc[j]);

  // (2) the layout in the object basis, on top.
  const T* cb = cov + b * p.cov_bstride;
  for (int k = 0; k < p.K; ++k) {
#pragma unroll
    for (int s = 0; s < kShifts; ++s) {
      const int yy = y + s / 3 - 1, xx = x + s % 3 - 1;
      if (yy < 0 || yy >= p.H || xx < 0 || xx >= p.W) continue;
      const float v = load_f(cb, k * HW + yy * static_cast<size_t>(p.W) + xx);
      const size_t w0 = ((static_cast<size_t>(b) * p.K + k) * kShifts + s)
                        * p.F + f0;
#pragma unroll
      for (int j = 0; j < kDF; ++j) {
        if (j < nf) acc[j] = fmaf(v, load_f(wk, w0 + j), acc[j]);
      }
    }
  }

  // The norm or the bias, the leaky ReLU, T.
  T* o = out + ((b * HW + y * static_cast<size_t>(p.W) + x) * p.F + f0);
#pragma unroll
  for (int j = 0; j < kDF; ++j) {
    if (j >= nf) break;
    const int f = f0 + j;
    float r;
    if (p.norm) {
      r = __fadd_rn(__fmul_rn(__fsub_rn(round_t<T>(acc[j]), p.mean[f]),
                              p.mul[f]), p.shift[f]);
    } else {
      r = __fadd_rn(acc[j], p.shift[f]);
    }
    r = round_t<T>(r);
    r = r > 0.0f ? r : round_t<T>(__fmul_rn(r, 0.2f));
    if constexpr (sizeof(T) == 4) {
      o[j] = r;
    } else {
      o[j] = __bfloat16_as_ushort(__float2bfloat16_rn(r));
    }
  }
}

uint16_t code(int plane, int dy, int dx) {
  return static_cast<uint16_t>((plane << 4) | (dy << 2) | dx);
}

// The halves of the product over `planes` planes at the 9 shifts, paired
// so that the two halves of a step lie a row (dy 0 with 1) or a plane (dy
// 2 with dy 2) apart; with an odd count of planes the last plane's dy 2
// row pairs within itself and with a pad. Returns the count (even).
int pair_planes(uint16_t* out, int planes) {
  int n = 0;
  for (int pl = 0; pl < planes; ++pl) {
    for (int dx = 0; dx < 3; ++dx) {
      out[n++] = code(pl, 0, dx);
      out[n++] = code(pl, 1, dx);
    }
  }
  for (int pl = 0; pl + 1 < planes; pl += 2) {
    for (int dx = 0; dx < 3; ++dx) {
      out[n++] = code(pl, 2, dx);
      out[n++] = code(pl + 1, 2, dx);
    }
  }
  if (planes % 2) {
    out[n++] = code(planes - 1, 2, 0);
    out[n++] = code(planes - 1, 2, 2);
    out[n++] = kPad;
    out[n++] = code(planes - 1, 2, 1);
  }
  return n;
}

void derive(Params& p) {
  p.J8 = (p.K + 7) / 8;
  p.LH = pair_planes(p.lay, p.J8);
  p.packed = p.C <= 4;
  if (p.packed) {
    // Slots of pixels (x, x + 1) read at columns dx 0 and 2.
    const uint16_t halves[6] = {code(0, 0, 0), code(0, 1, 0), code(0, 0, 2),
                                code(0, 1, 2), code(0, 2, 0), code(0, 2, 2)};
    p.JI = 1;
    p.IH = 6;
    for (int i = 0; i < 6; ++i) p.im[i] = halves[i];
  } else {
    p.JI = (p.C + 7) / 8;
    p.IH = pair_planes(p.im, p.JI);
  }
}

// The features a block computes (128, 64 or 32: the largest that divides F
// and fits) and the stages of its ring (4 down to 2); false if none fits.
bool plan(Params& p, int* nt, int* ns) {
  for (int n : {128, 64, 32}) {
    if (p.F % n) continue;
    for (int s = kMaxStages; s >= 2; --s) {
      const int total = n == 128   ? Layout<128>(p, s).total
                        : n == 64 ? Layout<64>(p, s).total
                                  : Layout<32>(p, s).total;
      if (total <= kSmemMax) {
        *nt = n;
        *ns = s;
        return true;
      }
    }
  }
  return false;
}

template <int NT>
int launch(Params p, int device, cudaStream_t stream) {
  p.tiles_w = (p.W + kTW - 1) / kTW;
  p.tiles = p.H * p.tiles_w;
  p.n_blocks = p.F / NT;
  const long long items = static_cast<long long>(p.B) * p.n_blocks * p.tiles;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  const int smem = Layout<NT>(p, p.NS).total;
  static int raised = 0;  // the dynamic shared memory already allowed
  cudaError_t e;
  if (smem > raised) {
    e = cudaFuncSetAttribute(ag_objconv_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = smem;
  }
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(items < sms ? items : sms);
  ag_objconv_kernel<NT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA-core path's launch: T float (fp32) or uint16_t (bf16 bits).
template <typename T>
int launch_direct(const Params& p, const void* cov, const void* wk,
                  const void* img, const void* wimg, void* out,
                  cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>(p.B) * p.H * ((p.W + 31) / 32);
  const int fblocks = (p.F + kDF * kDWarps - 1) / (kDF * kDWarps);
  if (tiles >= (1LL << 31) || fblocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ag_objconv_direct_kernel<T>
      <<<dim3(static_cast<unsigned>(tiles), fblocks), 32 * kDWarps, 0,
         stream>>>(p, static_cast<const T*>(cov), static_cast<const T*>(wk),
                   static_cast<const T*>(img), static_cast<const T*>(wimg),
                   static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cov (B, K, H, W), maps contiguous, sample stride cov_bstride; wk (B, K,
// 9, F), img (B, H, W, C), wimg (F, C, 3, 3) and out (B, H, W, F),
// contiguous, all fp32 (bf16 0) or all bf16 (bf16 1). norm 1: mean, mul and
// shift (F,) fp32, y = (v in the compute type - mean) * mul + shift; norm 0:
// shift (F,) fp32, y = v + shift; then the leaky ReLU. bf16 with F a
// multiple of 32, K <= 56 and C <= 16 runs on the tensor cores, everything
// else on the CUDA cores. Launches on `stream` with `device` current,
// restores the caller's device, and returns cudaGetLastError() after the
// launch.
int ag_objconv_forward(const void* cov, long long cov_bstride, const void* wk,
                       const void* img, const void* wimg, const void* mean,
                       const void* mul, const void* shift, void* out, int B,
                       int K, int H, int W, int F, int C, int norm, int bf16,
                       int device, void* stream) {
  if (B < 1 || H < 1 || W < 1 || K < 1 || C < 1 || F < 1 ||
      shift == nullptr || (norm && (mean == nullptr || mul == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.cov = static_cast<const uint16_t*>(cov);
  p.wk = static_cast<const uint16_t*>(wk);
  p.img = static_cast<const uint16_t*>(img);
  p.wimg = static_cast<const uint16_t*>(wimg);
  p.mean = static_cast<const float*>(mean);
  p.mul = static_cast<const float*>(mul);
  p.shift = static_cast<const float*>(shift);
  p.out = static_cast<uint16_t*>(out);
  p.cov_bstride = cov_bstride;
  p.B = B;
  p.K = K;
  p.H = H;
  p.W = W;
  p.F = F;
  p.C = C;
  p.norm = norm;
  int nt = 0;
  bool tensor_cores = bf16 && F % 32 == 0 && F <= 1024 &&
                      K <= kMaxMaps && C <= kMaxImgCh;
  if (tensor_cores) {
    p.vec = W % 8 == 0 && cov_bstride % 8 == 0 &&
            reinterpret_cast<uintptr_t>(cov) % 16 == 0;
    derive(p);
    tensor_cores = plan(p, &nt, &p.NS);
  }
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (!tensor_cores) {
    err = bf16 ? launch_direct<uint16_t>(p, cov, wk, img, wimg, out, s)
               : launch_direct<float>(p, cov, wk, img, wimg, out, s);
  } else {
    err = nt == 128  ? launch<128>(p, device, s)
          : nt == 64 ? launch<64>(p, device, s)
                     : launch<32>(p, device, s);
  }
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // extern "C"
