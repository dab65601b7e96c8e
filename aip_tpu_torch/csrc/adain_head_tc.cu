// AdaIN encoder head and decoder tail on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces, for bf16 tensors, the TPU kernels of aip_tpu/ops/pallas/adain_head.py:
//   * encode_head_pallas (:174)  ->  aip_encode_head_tc
//       reflect-pad -> conv 3->64 (1x1 RGB conv folded in) -> ReLU ->
//       reflect-pad -> conv 64->64 -> ReLU -> 2x2 ceil-mode max pool
//       x [B,H,W,3] -> [B,ceil(H/2),ceil(W/2),64]
//   * decode_tail_pallas (:278)  ->  aip_decode_tail_tc
//       nearest up2x -> reflect-pad -> conv 64->64 -> ReLU ->
//       reflect-pad -> conv 64->3
//       y [B,h,w,64] -> [B,2h,2w,3]
// The fp32 route stays in adain_head.cu.
//
// Rounding points (those of the TPU kernel in bf16): bf16 inputs and
// weights, exact products, fp32 sums; biases added in fp32; relu1_1 (head)
// and relu(z) (tail) rounded to bf16 before the next conv; the output
// rounded to bf16. The folded conv1 weights arrive rounded to bf16.
//
// What bounds it on the H100: operations. A 512^2 image costs ~20 GFLOP per
// chain (the 64->64 conv 19.3) against ~10 MB of bf16 in and out, far above
// the ~295 FLOP/byte ridge, so only the tensor cores move it: the fp32
// CUDA-core kernels ran at half the 67 TFLOP/s fp32 peak.
//
// Design:
//   * Every conv is an implicit GEMM on the tensor cores, bf16 in, fp32
//     accumulate. For the 64->64 conv, M is the pixels of a tile, N the 64
//     output channels, K 9 taps x 64 input channels. The A rows of a tap are
//     the tile's pixels shifted by (dy, dx) in a bf16 NHWC window in shared
//     memory (128 B a pixel); ldmatrix takes one address per row, so any
//     shift and any row order costs nothing. Each pixel's eight 16-byte
//     chunks are XOR-swizzled by its index, so the eight rows of every 8x8
//     matrix hit distinct banks.
//   * The 64->64 conv runs on wgmma.m64n64k16: each warp's A (its own 16
//     rows of a warpgroup's 64) comes from registers, loaded by ldmatrix one
//     k-step ahead in two buffers; B is w2 in shared memory, read through a
//     128B-swizzle descriptor (w2's layout is that swizzle, so the block's
//     shared memory is aligned to 1024 B). The accumulators have the
//     mma.sync layout, so the epilogues are the same. The small convs (3->64,
//     64->3) use mma.sync.m16n8k16.
//   * Resident weights: a persistent grid of one block per SM walks over
//     (image, tile) work items. The block copies w2 (72 KB bf16, already in
//     its swizzled shared-memory order) and the small conv's B fragments
//     once, with cp.async, and keeps them. Nothing is re-streamed per tile.
//   * Head (256 threads, a 16x32 output tile, 162 KB of shared memory):
//     conv1 runs on the tensor cores too, K = 27 padded to 32, its A
//     fragments gathered from a staged 20x36x3 patch of x at the reflected
//     coordinates (relu1_1's halo is relu1_1 AT THE REFLECTED COORDINATE:
//     double reflection does not commute with conv1). relu1_1 goes to
//     shared memory as bf16, an 18x34 halo. The next tile's x patch is
//     loaded into registers while this tile's MMAs run. Each warp owns two
//     output rows x 32 columns (four m16 tiles, 128 accumulators); the rows
//     of an m16 tile are ordered (2c, 2c+1) so that a 2x2 pool window lies
//     in one thread's fragments (rows g and g+8 of two m16 tiles): bias,
//     ReLU and the ceil-mode pool run on the accumulators, and only in-image
//     taps count for odd H or W.
//   * Tail (256 threads, a 16x32 output tile, 209 KB): the y window (10x18
//     pixels) is double-buffered with cp.async, the next tile's in flight
//     while this one computes. The upsampled map is never materialised:
//     up2x + reflect-pad is an edge-clamped 2x repeat, so ldmatrix rows
//     point at y(clamp(r,0,2h-1)/2, clamp(c,0,2w-1)/2). The 64->64 conv
//     computes z on the 18x34 halo (1.2x the output, against 1.31x for the
//     fp32 kernel's 16->14 tiles) as 40 m16 tiles, five per warp (160
//     accumulators; ten warps of four would cap a thread at 168 registers,
//     since three warps then share an SM quarter, and spill); relu(z)
//     goes to shared memory as bf16, border rows and columns are copied
//     from their mirror (z(-1) = z(1), z(H) = z(H-2)), and the 64->3 conv
//     runs with N = 3 padded to 8.
//
// Interface: plain C, loaded with ctypes. Every pointer is a device pointer,
// the stream is a cudaStream_t; each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;
constexpr int kPix = 128;                 // bytes of one 64-channel bf16 pixel
constexpr int kTH = 16, kTW = 32;         // output tile (head: before the pool)
constexpr int kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHalo = kHH * kHW;          // 612 pixels of relu1_1 or z
constexpr int kHaloTiles = (kHalo + 15) / 16;  // 39 m16 tiles
constexpr int kW2Bytes = 9 * kC * kPix;   // 73728

// Head.
constexpr int kEncThreads = 256;
constexpr int kXH = kTH + 4, kXW = kTW + 4;     // x patch, rows r0-2 .. r0+TH+1
constexpr int kXElems = kXH * kXW * 3;          // 2160
constexpr int kXPer = (kXElems + kEncThreads - 1) / kEncThreads;
constexpr int kEncW1Bytes = 2 * 8 * 32 * 8;     // B fragments [kstep 2][ntile 8][lane][4 bf16]
constexpr int kEncOffW1 = kW2Bytes;
constexpr int kEncOffB1 = kEncOffW1 + kEncW1Bytes;
constexpr int kEncOffB2 = kEncOffB1 + kC * 4;
constexpr int kEncOffX = kEncOffB2 + kC * 4;
constexpr int kEncOffR1 = (kEncOffX + kXElems * 2 + 127) / 128 * 128;
constexpr int kEncSmem = kEncOffR1 + kHalo * kPix + 1024;   // + alignment slack

// Tail.
constexpr int kDecThreads = 256;
constexpr int kDecMT = 5;                            // m16 tiles of the halo per warp
constexpr int kYH = kTH / 2 + 2, kYW = kTW / 2 + 2;  // 10 x 18 y pixels
constexpr int kYBytes = kYH * kYW * kPix;            // 23040
constexpr int kDecW1Bytes = 36 * 32 * 8;             // B fragments [kstep 36][lane][4 bf16]
constexpr int kDecOffW1 = kW2Bytes;
constexpr int kDecOffB2 = kDecOffW1 + kDecW1Bytes;
constexpr int kDecOffB1 = kDecOffB2 + kC * 4;
constexpr int kDecOffY = (kDecOffB1 + 8 * 4 + 127) / 128 * 128;
constexpr int kDecOffZ = kDecOffY + 2 * kYBytes;
constexpr int kDecSmem = kDecOffZ + kHalo * kPix + 1024;    // + alignment slack

static_assert(kEncSmem <= 232448 && kDecSmem <= 232448, "shared memory per block");
static_assert(kHaloTiles <= kDecMT * (kDecThreads / 32), "the tail's warps cover the halo");
static_assert(2 * (kEncThreads / 32) == kTH && 2 * (kDecThreads / 32) == kTH,
              "a warp owns two output rows");

// ReflectionPad2d(1) index for g in [-1, n] (n >= 2).
__device__ __forceinline__ int reflect1(int g, int n) {
  g = g < 0 ? -g : g;
  return g >= n ? 2 * n - 2 - g : g;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps a register live (and unmoved) up to this point: the compiler does not
// know that an issued wgmma still reads its A operand and writes its
// accumulators.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// Makes this thread's earlier shared-memory writes (cp.async included) visible
// to wgmma, which reads B through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major bf16 tile with 128-byte rows, 16-byte
// chunks XOR-swizzled by row (128B swizzle), 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (this warp's 16 rows x 64 of a 64x64 warpgroup tile) += a (registers) * B (desc).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies `bytes` (a multiple of 16) from global to shared memory with cp.async.
__device__ __forceinline__ void stage(uint32_t dst, const void* src, int bytes) {
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) cp_async16(dst + i, s + i);
}

// acc[mt][nt] += sum over 9 taps x 64 channels of A(mt rows, tap) * w2, the
// warp's m16 tile mt being its 16 rows of the warpgroup's mt-th wgmma.
// row_of(mt, tap) gives this lane's A row: .x its byte address in shared
// memory, .y its swizzle (the chunk c of a pixel lives at c ^ swizzle). The
// lane's row of its m16 tile is lane & 15, and its chunk half lane >> 4.
// w2s (1024-B aligned): [9 taps][64 out][8 chunks, swizzled by out & 7][8 in]
// bf16, one 128B-swizzled K-major 64x64 B tile a tap. All four warps of a
// warpgroup must call it together.
template <int MT, typename RowFn>
__device__ __forceinline__ void conv64(float (&acc)[MT][8][4], uint32_t w2s, RowFn row_of) {
  const int ahi = (threadIdx.x & 31) >> 4;
  const uint64_t desc0 = sw128_desc(w2s);
  uint32_t a[2][MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[0][mt][r] = a[1][mt][r] = 0u;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(acc[mt][nt][e]);
  }
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    uint32_t arow[MT], asw[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint2 r = row_of(mt, tap);
      arow[mt] = r.x;
      asw[mt] = r.y;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int buf = kk & 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(arow[mt] + ((((kk << 1) | ahi) ^ asw[mt]) << 4), a[buf][mt][0], a[buf][mt][1],
                a[buf][mt][2], a[buf][mt][3]);
      wgmma_fence();
      const uint64_t desc = desc0 + (uint64_t)((tap * kC * kPix + kk * 32) >> 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_m64n64k16(acc[mt], a[buf][mt], desc);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) keep(a[buf ^ 1][mt][r]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(acc[mt][nt][e]);
}

// Tile t -> (image, first output row, first output column).
__device__ __forceinline__ void tile_origin(int t, int tiles_x, int tiles_y, int& b, int& r0,
                                            int& c0) {
  const int per = tiles_x * tiles_y;
  b = t / per;
  const int rem = t - b * per;
  r0 = (rem / tiles_x) * kTH;
  c0 = (rem % tiles_x) * kTW;
}

// ---------------------------------------------------------------------------
// Head
// ---------------------------------------------------------------------------

// Loads tile t's x patch into registers: patch (q, s) holds x at image row
// reflect1(r0-2+q) and column reflect1(c0-2+s) (clamped to [-1, n] first;
// positions beyond that are never read).
__device__ __forceinline__ void fetch_x(const uint16_t* __restrict__ x, int t, int ntiles,
                                        int tiles_x, int tiles_y, int H, int W,
                                        uint16_t (&pf)[kXPer]) {
  if (t >= ntiles) return;
  int b, r0, c0;
  tile_origin(t, tiles_x, tiles_y, b, r0, c0);
  const uint16_t* xb = x + (size_t)b * H * W * 3;
#pragma unroll
  for (int k = 0; k < kXPer; ++k) {
    const int e = threadIdx.x + k * kEncThreads;
    if (e < kXElems) {
      const int ci = e % 3, p = e / 3, s = p % kXW, q = p / kXW;
      const int gr = reflect1(clampi(r0 - 2 + q, -1, H), H);
      const int gc = reflect1(clampi(c0 - 2 + s, -1, W), W);
      pf[k] = __ldg(xb + ((size_t)gr * W + gc) * 3 + ci);
    }
  }
}

__global__ void __launch_bounds__(kEncThreads, 1)
encode_head_tc_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ w1f,
                      const float* __restrict__ b1, const uint4* __restrict__ w2p,
                      const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H,
                      int W, int tiles_x, int tiles_y, int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t w2s = smem_u32(smem);
  const uint2* w1s = reinterpret_cast<const uint2*>(smem + kEncOffW1);
  float* b1s = reinterpret_cast<float*>(smem + kEncOffB1);
  float* b2s = reinterpret_cast<float*>(smem + kEncOffB2);
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + kEncOffX);
  unsigned char* r1 = smem + kEncOffR1;
  const uint32_t r1s = smem_u32(r1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  stage(w2s, w2p, kW2Bytes);
  stage(smem_u32(smem + kEncOffW1), w1f, kEncW1Bytes);
  cp_async_commit();
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }

  // This lane's 8 k indices of conv1's A fragments (k = tap * 3 + ci, 27
  // real of 32) as offsets into the x patch; -1 for the zero padding.
  int koff[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 16 * (i >> 2) + 2 * t4 + (i & 1) + 8 * ((i >> 1) & 1);
    const int tap = k / 3;
    koff[i] = k < 27 ? ((tap / 3) * kXW + tap % 3) * 3 + k % 3 : -1;
  }

  const int hp = (H + 1) / 2, wp = (W + 1) / 2;
  uint16_t pf[kXPer];
  int tile = blockIdx.x;
  fetch_x(x, tile, ntiles, tiles_x, tiles_y, H, W, pf);
  cp_async_wait<0>();
  fence_async_shared();  // w2 (cp.async) is read by wgmma through the async proxy

  for (; tile < ntiles; tile += gridDim.x) {
    int b, r0, c0;
    tile_origin(tile, tiles_x, tiles_y, b, r0, c0);
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      const int e = tid + k * kEncThreads;
      if (e < kXElems) xs[e] = pf[k];
    }
    __syncthreads();  // x patch (and, once, the weights) ready; last tile's conv2 done
    fetch_x(x, tile + gridDim.x, ntiles, tiles_x, tiles_y, H, W, pf);

    // conv1 on the 18x34 halo of relu1_1, each position at its reflected
    // coordinate: M = 612 halo pixels (39 m16 tiles), N = 64, K = 32.
    for (int mt = warp; mt < kHaloTiles; mt += kEncThreads / 32) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(mt * 16 + g + 8 * h, kHalo - 1);
        const int i = p / kHW, j = p % kHW;
        const int rr = reflect1(min(r0 - 1 + i, H), H);
        const int cc = reflect1(min(c0 - 1 + j, W), W);
        base[h] = ((rr + 1 - r0) * kXW + (cc + 1 - c0)) * 3;
      }
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t v[2][4];  // [row half][k slot]
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = koff[4 * s + q];
            v[h][q] = o >= 0 ? xs[base[h] + o] : 0u;
          }
        const uint32_t a[4] = {v[0][0] | (v[0][1] << 16), v[1][0] | (v[1][1] << 16),
                               v[0][2] | (v[0][3] << 16), v[1][2] | (v[1][3] << 16)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint2 bf = w1s[(s * 8 + nt) * 32 + lane];
          mma_bf16(acc[nt], a, bf.x, bf.y);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        if (p < kHalo) {
          const int sw = (p >> 1) & 7;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int ch = nt * 8 + 2 * t4;
            const float lo = fmaxf(acc[nt][2 * h] + b1s[ch], 0.f);
            const float hi = fmaxf(acc[nt][2 * h + 1] + b1s[ch + 1], 0.f);
            *reinterpret_cast<uint32_t*>(r1 + p * kPix + ((nt ^ sw) << 4) + t4 * 4) =
                pack_bf16(lo, hi);
          }
        }
      }
    }
    __syncthreads();  // relu1_1 halo ready

    // conv2: warp w owns output rows 2w, 2w+1, all 32 columns. m16 tile mt
    // is row 2w + (mt & 1), columns 16 * (mt >> 1) + (2c, 2c+1), c = 0..7:
    // row m of the tile is column 2 (m & 7) + (m >> 3).
    float acc[4][8][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    const int m = lane & 15;
    const int colm = 2 * (m & 7) + (m >> 3);
    conv64<4>(acc, w2s, [&](int mt, int tap) {
      const int P = (2 * warp + (mt & 1) + tap / 3) * kHW + 16 * (mt >> 1) + colm + tap % 3;
      return make_uint2(r1s + P * kPix, (P >> 1) & 7);
    });

    // Bias, ReLU and the 2x2 ceil-mode pool over in-image taps, in registers.
    const int pr = (r0 >> 1) + warp;
    const int ra = r0 + 2 * warp;
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int ca = c0 + 16 * pp + 2 * g;
      const int pc = (c0 >> 1) + 8 * pp + g;
      if (ra < H && ca < W) {
        const bool r_ok = ra + 1 < H, c_ok = ca + 1 < W;
        __nv_bfloat16* o = out + (((size_t)b * hp + pr) * wp + pc) * kC + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float mx = acc[2 * pp][nt][e];                            // (ra, ca)
            if (c_ok) mx = fmaxf(mx, acc[2 * pp][nt][2 + e]);         // (ra, ca+1)
            if (r_ok) mx = fmaxf(mx, acc[2 * pp + 1][nt][e]);         // (ra+1, ca)
            if (r_ok && c_ok) mx = fmaxf(mx, acc[2 * pp + 1][nt][2 + e]);
            v[e] = fmaxf(mx + b2s[nt * 8 + 2 * t4 + e], 0.f);
          }
          *reinterpret_cast<uint32_t*>(o + nt * 8) = pack_bf16(v[0], v[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tail
// ---------------------------------------------------------------------------

// Issues the cp.async copies of tile t's y window: window (a, c) holds y at
// row clamp(r0/2 - 1 + a) and column clamp(c0/2 - 1 + c), chunk k of a
// pixel Q at k ^ (Q & 7).
__device__ __forceinline__ void fetch_y(const __nv_bfloat16* __restrict__ y, uint32_t dst,
                                        int t, int ntiles, int tiles_x, int tiles_y, int h,
                                        int w) {
  if (t >= ntiles) return;
  int b, r0, c0;
  tile_origin(t, tiles_x, tiles_y, b, r0, c0);
  const int y0 = r0 / 2 - 1, x0 = c0 / 2 - 1;
  for (int i = threadIdx.x; i < kYH * kYW * 8; i += kDecThreads) {
    const int k = i & 7, q = i >> 3, a = q / kYW, c = q % kYW;
    const int yr = clampi(y0 + a, 0, h - 1), yc = clampi(x0 + c, 0, w - 1);
    cp_async16(dst + q * kPix + ((k ^ (q & 7)) << 4),
               y + (((size_t)b * h + yr) * w + yc) * kC + k * 8);
  }
}

__device__ __forceinline__ void copy_pixel(unsigned char* zs, int to, int from) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<uint4*>(zs + to * kPix + ((k ^ (to & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(zs + from * kPix + ((k ^ (from & 7)) << 4));
}

__global__ void __launch_bounds__(kDecThreads, 1)
decode_tail_tc_kernel(const __nv_bfloat16* __restrict__ y, const uint4* __restrict__ w2p,
                      const float* __restrict__ b2, const uint4* __restrict__ w1f,
                      const float* __restrict__ b1, __nv_bfloat16* __restrict__ out, int h,
                      int w, int tiles_x, int tiles_y, int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t w2s = smem_u32(smem);
  const uint2* w1s = reinterpret_cast<const uint2*>(smem + kDecOffW1);
  float* b2s = reinterpret_cast<float*>(smem + kDecOffB2);
  float* b1s = reinterpret_cast<float*>(smem + kDecOffB1);
  const uint32_t ys = smem_u32(smem + kDecOffY);
  unsigned char* zs = smem + kDecOffZ;
  const uint32_t zss = smem_u32(zs);

  const int H = 2 * h, W = 2 * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m = lane & 15;

  stage(w2s, w2p, kW2Bytes);
  stage(smem_u32(smem + kDecOffW1), w1f, kDecW1Bytes);
  if (tid < kC) b2s[tid] = b2[tid];
  if (tid < 8) b1s[tid] = tid < 3 ? b1[tid] : 0.f;
  int tile = blockIdx.x;
  fetch_y(y, ys, tile, ntiles, tiles_x, tiles_y, h, w);
  cp_async_commit();

  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    int b, r0, c0;
    tile_origin(tile, tiles_x, tiles_y, b, r0, c0);
    fetch_y(y, ys + (buf ^ 1) * kYBytes, tile + gridDim.x, ntiles, tiles_x, tiles_y, h, w);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();  // this tile's y window ready; last tile's tail conv done

    // conv 64->64 on the z halo: halo pixel p = (i, j) is z at (r0-1+i,
    // c0-1+j); tap (dy, dx) reads u at (r0-2+i+dy, c0-2+j+dx).
    const uint32_t yb = ys + buf * kYBytes;
    const int y0 = r0 / 2 - 1, x0 = c0 / 2 - 1;
    float acc[kDecMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kDecMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    int hi_[kDecMT], hj_[kDecMT];
#pragma unroll
    for (int mt = 0; mt < kDecMT; ++mt) {
      const int p = min((kDecMT * warp + mt) * 16 + m, kHalo - 1);
      hi_[mt] = p / kHW;
      hj_[mt] = p % kHW;
    }
    conv64<kDecMT>(acc, w2s, [&](int mt, int tap) {
      const int a = (clampi(r0 - 2 + hi_[mt] + tap / 3, 0, H - 1) >> 1) - y0;
      const int c = (clampi(c0 - 2 + hj_[mt] + tap % 3, 0, W - 1) >> 1) - x0;
      const int q = a * kYW + c;
      return make_uint2(yb + q * kPix, q & 7);
    });
#pragma unroll
    for (int mt = 0; mt < kDecMT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (kDecMT * warp + mt) * 16 + g + 8 * hh;
        if (p < kHalo) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int ch = nt * 8 + 2 * t4;
            const float lo = fmaxf(acc[mt][nt][2 * hh] + b2s[ch], 0.f);
            const float hi = fmaxf(acc[mt][nt][2 * hh + 1] + b2s[ch + 1], 0.f);
            *reinterpret_cast<uint32_t*>(zs + p * kPix + ((nt ^ (p & 7)) << 4) + t4 * 4) =
                pack_bf16(lo, hi);
          }
        }
      }
    __syncthreads();  // z halo written

    // Reflect the halo's border: z(-1) = z(1), z(H) = z(H-2); rows, then
    // columns (which then carry the corners).
    const int gi = H + 1 - r0, gj = W + 1 - c0;  // halo index of z row H / column W
    if (r0 == 0 || gi < kHH || c0 == 0 || gj < kHW) {
      for (int j = tid; j < kHW; j += kDecThreads) {
        if (r0 == 0) copy_pixel(zs, j, 2 * kHW + j);
        if (gi < kHH) copy_pixel(zs, gi * kHW + j, (gi - 2) * kHW + j);
      }
      __syncthreads();
      for (int i = tid; i < kHH; i += kDecThreads) {
        if (c0 == 0) copy_pixel(zs, i * kHW, i * kHW + 2);
        if (gj < kHW) copy_pixel(zs, i * kHW + gj, i * kHW + gj - 2);
      }
      __syncthreads();
    }

    // conv 64->3 (N padded to 8) on the 16x32 output tile: two output rows
    // a warp; m16 tile mt is row 2w + (mt & 1), columns 16 * (mt >> 1) + m.
    {
      float o[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t arow[4], asw[4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int p = (2 * warp + (mt & 1) + tap / 3) * kHW + 16 * (mt >> 1) + m + tap % 3;
          arow[mt] = zss + p * kPix;
          asw[mt] = p & 7;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint2 bf = w1s[(tap * 4 + kk) * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a[4];
            ldsm_x4(arow[mt] + ((((kk << 1) | (lane >> 4)) ^ asw[mt]) << 4), a[0], a[1], a[2],
                    a[3]);
            mma_bf16(o[mt], a, bf.x, bf.y);
          }
        }
      }
      if (t4 < 2) {  // output channels 2 t4, 2 t4 + 1: only 0, 1, 2 are real
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int R = r0 + 2 * warp + (mt & 1);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int C = c0 + 16 * (mt >> 1) + g + 8 * hh;
            if (R < H && C < W) {
              __nv_bfloat16* dst = out + (((size_t)b * H + R) * W + C) * 3 + 2 * t4;
              dst[0] = __float2bfloat16(o[mt][2 * hh] + b1s[2 * t4]);
              if (t4 == 0) dst[1] = __float2bfloat16(o[mt][2 * hh + 1] + b1s[1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// The persistent grid: at most one block per SM, never more than the tiles.
cudaError_t grid_size(long long ntiles, int& grid) {
  if (ntiles <= 0 || ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  grid = (int)(ntiles < sms ? ntiles : sms);
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory of a block of the head (0) or the tail (1): ptxas
// reports only static shared memory.
extern "C" int aip_adain_head_tc_smem(int tail) { return tail ? kDecSmem : kEncSmem; }

// x [B,H,W,3] bf16 (H, W >= 2), out [B,ceil(H/2),ceil(W/2),64] bf16.
// w1f: conv1's B fragments, bf16 [2 ksteps][8 ntiles][32 lanes][4] (the
// folded 3->64 weights, k = (dy*3+dx)*3 + ci, 27 padded to 32); b1 [64]
// fp32 (folded); w2p: bf16 [9 taps][64 out][8 chunks ^ (out & 7)][8 in];
// b2 [64] fp32.
extern "C" int aip_encode_head_tc(const void* x, const void* w1f, const void* b1,
                                  const void* w2p, const void* b2, void* out, int B, int H,
                                  int W, void* stream) {
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const long long ntiles = (long long)B * tiles_x * tiles_y;
  int grid = 0;
  cudaError_t e = grid_size(ntiles, grid);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(encode_head_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kEncSmem);
  if (e != cudaSuccess) return (int)e;
  encode_head_tc_kernel<<<grid, kEncThreads, kEncSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(w1f),
      static_cast<const float*>(b1), static_cast<const uint4*>(w2p),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), H, W, tiles_x, tiles_y,
      (int)ntiles);
  return (int)cudaGetLastError();
}

// y [B,h,w,64] bf16 (h, w >= 1), out [B,2h,2w,3] bf16. w2p as above; b2
// [64] fp32; w1f: the 64->3 conv's B fragments, bf16 [36 ksteps][32
// lanes][4] (k = (dy*3+dx)*64 + ci, outputs 3 padded to 8); b1 [3] fp32.
extern "C" int aip_decode_tail_tc(const void* y, const void* w2p, const void* b2,
                                  const void* w1f, const void* b1, void* out, int B, int h,
                                  int w, void* stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int tiles_x = (2 * w + kTW - 1) / kTW, tiles_y = (2 * h + kTH - 1) / kTH;
  const long long ntiles = (long long)B * tiles_x * tiles_y;
  int grid = 0;
  cudaError_t e = grid_size(ntiles, grid);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(decode_tail_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDecSmem);
  if (e != cudaSuccess) return (int)e;
  decode_tail_tc_kernel<<<grid, kDecThreads, kDecSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const uint4*>(w2p),
      static_cast<const float*>(b2), static_cast<const uint4*>(w1f),
      static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(out), h, w, tiles_x, tiles_y,
      (int)ntiles);
  return (int)cudaGetLastError();
}
