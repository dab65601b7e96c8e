// AdaIN encoder head and decoder tail on Hopper's tensor cores (sm_90a), fp32.
//
// Replaces, for fp32 tensors, the TPU kernels of aip_tpu/ops/pallas/adain_head.py:
//   * encode_head_pallas (:174)  ->  aip_encode_head
//       reflect-pad -> conv 3->64 (1x1 RGB conv folded in) -> ReLU ->
//       reflect-pad -> conv 64->64 -> ReLU -> 2x2 ceil-mode max pool
//       x [B,H,W,3] -> [B,ceil(H/2),ceil(W/2),64]
//   * decode_tail_pallas (:278)  ->  aip_decode_tail
//       nearest up2x -> reflect-pad -> conv 64->64 -> ReLU ->
//       reflect-pad -> conv 64->3
//       y [B,h,w,64] -> [B,2h,2w,3]
// The bf16 route is adain_head_tc.cu.
//
// What bounds it on the H100: operations. A 512^2 image costs ~20 GFLOP per
// chain (the 64->64 conv 19.3) against ~10 MB of fp32 in and out. On the
// CUDA cores (67 TFLOP/s) no kernel can beat 9.664 ms for a batch of 32;
// the tensor cores compute an fp32-accurate product faster: with each
// operand split into a TF32 "big" and "small" part, small*big + big*small
// + big*big keeps fp32 accuracy, and three TF32 products at 495 TFLOP/s
// bound the same batch at 3.924 ms.
//
// Design:
//   * The 64->64 conv is an implicit GEMM on wgmma.m64n64k8.tf32: M is the
//     256 pixels of a tile (two warpgroups, two m16 tiles a warp), N the 64
//     output channels, K 9 taps x 64 input channels. A (the activations)
//     comes from registers: ldmatrix reads the tf32 fragment of a k-step
//     (8 channels of 16 pixels) from an fp32 NHWC window in shared memory,
//     256 B a pixel, its sixteen 16-byte chunks XOR-swizzled by the pixel so
//     that the 8 rows of each 8x8 matrix hit distinct banks; each value is
//     split there, hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), so
//     shared memory holds no second copy of the activations. B (w2) arrives
//     split on the host, hi and lo, each a K-major 64x32 block per 32 input
//     channels in the 128B-swizzle order the descriptor reads. Per k-step
//     lo*Bhi and hi*Blo are issued before hi*Bhi.
//   * Accuracy: the tensor cores' fp32 sums lose bits each step (they
//     round toward zero), so one accumulator over all 216 wgmma steps
//     drifts: 2.5-5.1e-6 of the largest output against float64 on the
//     card (one over 3 taps 0.9-1.5e-6), past chip_smoke.py's 1.5e-6 gate.
//     Each tap's 24 steps start a fresh partial sum (scale-d = 0), added to
//     a total in registers on the CUDA cores: 5-7e-7, as close as the fp32
//     FMA chain (6-9e-7). That doubles the accumulators (128 registers), so
//     a warp owns two m16 tiles and a tile is 256 pixels. The drains cost
//     2-5 % against a single partial.
//   * Shared memory: fp32 doubles every operand. w2 hi + lo is 288 KB, more
//     than a block has, so the weights stream tap by tap (32 KB, hi then
//     lo) through a ring of 3 stages, one bulk copy (TMA) a tap completing
//     on an mbarrier; every block reads the same 288 KB, which L2 holds.
//     A tap's stage is refilled by the last warp to finish it (a shared
//     counter), three taps ahead, so a tap's copy has two taps' MMAs to land.
//   * The small convs (4.5 % of the operations). conv1 (3->64, K = 27 padded
//     to 32) runs on mma.sync.m16n8k8.tf32 with the same three products, its
//     B fragments split on the host: as fp32 FMAs, one pixel a warp and a
//     dependent chain of 27 FMAs a lane, it was latency-bound at 8 warps an
//     SM with the tensor cores idle meanwhile. The tail's 64->3 (N = 3 would
//     waste 5/8 of an n8 MMA) runs as fp32 FMAs on the CUDA cores, bound by
//     shared-memory wavefronts: each lane keeps one 4-channel chunk's 108
//     weights in registers, so a warp reads only z (two pixels a step).
//   * A persistent grid of one block per SM walks over (image, tile) items:
//     batch 1 at 512^2 has 1024 head tiles for 132 SMs, and no grid
//     dimension caps the batch.
//   * Head (16x16 output tile before the pool, 199 KB of shared memory):
//     relu1_1's 18x18 halo is relu1_1 AT THE REFLECTED COORDINATE (double
//     reflection does not commute with conv1), computed by conv1 from a
//     staged 20x20x3 patch of x stored at reflected coordinates, so each A
//     element is a fixed offset per lane (the next tile's patch is loaded
//     into registers meanwhile). The rows of an m16 tile are ordered (2c,
//     2c+1) so that a 2x2 pool window lies in one thread's fragments: bias,
//     ReLU and the ceil-mode pool run on the totals, and only in-image taps
//     count for odd H or W.
//   * Tail (14x14 output tile, 208 KB): z is computed on its 16x16 halo
//     (256 pixels: 1.31x the output). The y window (9x9 pixels) is
//     double-buffered with cp.async, the next tile's in flight while this
//     one computes. up2x + reflect-pad is an edge-clamped 2x repeat, so the
//     ldmatrix rows point at y(clamp(r,0,2h-1)/2, clamp(c,0,2w-1)/2) and the
//     upsampled map is never materialised. relu(z) goes to shared memory in
//     fp32, each value also written to the border positions that mirror it
//     (z(-1) = z(1), z(H) = z(H-2)), so no pass and no barrier for the
//     border follow; then the 64->3 conv.
//
// Interface: plain C, loaded with ctypes. Every pointer is a device pointer,
// the stream is a cudaStream_t; each function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;
constexpr int kPix = kC * 4;              // bytes of one 64-channel fp32 pixel
constexpr int kThreads = 256;             // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;                    // tile edge of the 64->64 conv
constexpr int kE = kT + 2;                // 18: the head's halo edge
constexpr int kMT = 2;                    // m16 tiles a warp
constexpr int kBlockBytes = kC * 32 * 4;  // 8192: a K-major 64 x 32 fp32 B block
constexpr int kTapBytes = 4 * kBlockBytes;  // hi (2 blocks) + lo (2 blocks) of a tap
constexpr int kStages = 3;
constexpr int kRingBytes = kStages * kTapBytes;  // 98304

// Head.
constexpr int kHalo = kE * kE;                  // 324 pixels of relu1_1
constexpr int kXE = kT + 4;                     // 20: x patch edge, rows r0-2 .. r0+17
constexpr int kXElems = kXE * kXE * 3;          // 1200
constexpr int kXPer = (kXElems + kThreads - 1) / kThreads;
constexpr int kEncOffHalo = kRingBytes;
constexpr int kEncOffX = kEncOffHalo + kHalo * kPix;
constexpr int kEncOffW1 = kEncOffX + kXElems * 4;
constexpr int kHaloTiles = (kHalo + 15) / 16;   // 21 m16 tiles of conv1
constexpr int kEncW1Bytes = 4 * 8 * 32 * 16;    // conv1's B fragments, hi and lo
constexpr int kEncOffB1 = kEncOffW1 + kEncW1Bytes;
constexpr int kEncOffB2 = kEncOffB1 + kC * 4;
constexpr int kEncOffBar = kEncOffB2 + kC * 4;
constexpr int kEncSmem = kEncOffBar + 64 + 1024;   // + alignment slack

// Tail.
constexpr int kOut = kT - 2;                    // 14: output tile edge
constexpr int kYE = kT / 2 + 1;                 // 9: y window edge
constexpr int kYBytes = kYE * kYE * kPix;       // 20736
constexpr int kDecW1Floats = 9 * 16 * 3 * 4;    // [tap][ci chunk][out][4 ci]
constexpr int kDecOffZ = kRingBytes;
constexpr int kDecOffY = kDecOffZ + kT * kT * kPix;
constexpr int kDecOffW1 = kDecOffY + 2 * kYBytes;
constexpr int kDecOffB2 = kDecOffW1 + kDecW1Floats * 4;
constexpr int kDecOffB1 = kDecOffB2 + kC * 4;
constexpr int kDecOffBar = kDecOffB1 + 4 * 4;
constexpr int kDecSmem = kDecOffBar + 64 + 1024;   // + alignment slack

static_assert(kEncSmem <= 232448 && kDecSmem <= 232448, "shared memory per block");
static_assert(2 * kWarps == kT && kMT == 2, "a warp owns two rows of 16 pixels");
static_assert(kEncOffBar % 8 == 0 && kDecOffBar % 8 == 0, "mbarrier alignment");

// ReflectionPad2d(1) index for g in [-1, n] (n >= 2).
__device__ __forceinline__ int reflect1(int g, int n) {
  g = g < 0 ? -g : g;
  return g >= n ? 2 * n - 2 - g : g;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a (16x8, row) * b (8x8, col); tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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

// Shared-memory descriptor of a K-major tile with 128-byte rows, 16-byte
// chunks XOR-swizzled by row (128B swizzle), 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (this warp's 16 rows x 64 of a 64x64 warpgroup tile) = a (registers,
// tf32) * B (desc, tf32) + (acc ? d : 0).
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// ---------------------------------------------------------------------------
// The weight ring: w2's taps, streamed by bulk copies into kStages stages
// ---------------------------------------------------------------------------

struct Ring {
  uint32_t smem;            // kStages x kTapBytes, 1024-B aligned
  uint32_t full;            // kStages mbarriers, 8 B apart: a tap has landed
  unsigned* done;           // kStages counters: warps done with a stage's tap
  const unsigned char* w;   // the packed taps in device memory
  int next;                 // this block's next tap (counted over its tiles)
  int total;                // 9 x this block's tiles
};

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
}

// Thread 0 only: tap g of this block's sequence into its stage.
__device__ __forceinline__ void ring_issue(const Ring& r, int g) {
  const int s = g % kStages;
  const uint32_t bar = r.full + 8 * s;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(kTapBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(r.smem + s * kTapBytes), "l"(r.w + (size_t)(g % 9) * kTapBytes), "r"(kTapBytes),
      "r"(bar) : "memory");
}

// Initialises the ring's barriers and issues its first taps; the caller
// synchronises the block before the first ring_conv.
__device__ __forceinline__ void ring_start(Ring& r, unsigned char* bars, const void* w,
                                           int tiles) {
  r.full = smem_u32(bars);
  r.done = reinterpret_cast<unsigned*>(bars + 8 * kStages);
  r.w = static_cast<const unsigned char*>(w);
  r.next = 0;
  r.total = 9 * tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(r.full + 8 * s) : "memory");
      r.done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < kStages && g < r.total; ++g) ring_issue(r, g);
  }
}

// This warp is done with tap g's stage; the last of the 8 warps refills it
// with tap g + kStages.
__device__ __forceinline__ void ring_release(const Ring& r, int g) {
  if ((threadIdx.x & 31) == 0 && atomicInc(r.done + g % kStages, kWarps - 1) == kWarps - 1 &&
      g + kStages < r.total)
    ring_issue(r, g + kStages);
  __syncwarp();
}

// tot[mt][nt][e] += the 64->64 conv of this warp's m16 tile mt (its 16 rows
// of the warpgroup's mt-th wgmma) over 9 taps x 64 channels, three TF32
// products a multiply-add. row_of(mt, tap) gives this lane's A row: .x the
// byte address of its pixel in shared memory, .y the pixel's swizzle (chunk
// c lives at c ^ swizzle). The lane's row of its m16 tile is lane & 15, and
// its chunk half lane >> 4. All 8 warps call it together. Each tap's sums
// (24 wgmma steps) form a partial that the CUDA cores add to tot, and the
// tap's stage is released once they are done.
template <typename RowFn>
__device__ __forceinline__ void ring_conv(float (&tot)[kMT][8][4], Ring& r, RowFn row_of) {
  const int lane = threadIdx.x & 31, half = lane >> 4;
  float part[kMT][8][4];
  uint32_t hi[2][kMT][4], lo[2][kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) hi[0][mt][q] = hi[1][mt][q] = lo[0][mt][q] = lo[1][mt][q] = 0u;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
  }
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap, ++r.next) {
    const int s = r.next % kStages;
    uint32_t arow[kMT], asw[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const uint2 rw = row_of(mt, tap);
      arow[mt] = rw.x;
      asw[mt] = rw.y;
    }
    mbar_wait(r.full + 8 * s, (r.next / kStages) & 1);
    const uint64_t desc0 = sw128_desc(r.smem + s * kTapBytes);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {  // k-step: input channels 8 ks .. 8 ks + 7
      const int buf = ks & 1;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t raw[4];
        ldsm_x4(arow[mt] + ((((ks << 1) | half) ^ asw[mt]) << 4), raw);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = __uint_as_float(raw[q]);
          hi[buf][mt][q] = tf32_rna(a);
          lo[buf][mt][q] = tf32_rna(a - __uint_as_float(hi[buf][mt][q]));
        }
      }
      wgmma_fence();
      const uint64_t dhi = desc0 + (uint64_t)((((ks >> 2) * kBlockBytes) + (ks & 3) * 32) >> 4);
      const uint64_t dlo = dhi + (uint64_t)((2 * kBlockBytes) >> 4);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        wgmma_tf32(part[mt], lo[buf][mt], dhi, ks > 0);  // a fresh partial a tap
        wgmma_tf32(part[mt], hi[buf][mt], dlo, 1);
        wgmma_tf32(part[mt], hi[buf][mt], dhi, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          keep(hi[buf ^ 1][mt][q]);
          keep(lo[buf ^ 1][mt][q]);
        }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          keep(part[mt][nt][e]);
          tot[mt][nt][e] += part[mt][nt][e];
        }
    ring_release(r, r.next);
  }
}

// Tile t -> (image, first row, first column) for tiles of edge `edge`.
__device__ __forceinline__ void tile_origin(int t, int edge, int tiles_x, int tiles_y, int& b,
                                            int& r0, int& c0) {
  const int per = tiles_x * tiles_y;
  b = t / per;
  const int rem = t - b * per;
  r0 = (rem / tiles_x) * edge;
  c0 = (rem % tiles_x) * edge;
}

// Tiles this block walks: blockIdx.x, + gridDim.x, ... below ntiles.
__device__ __forceinline__ int my_tiles(int ntiles) {
  return ((int)blockIdx.x < ntiles) ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
}

// ---------------------------------------------------------------------------
// Head
// ---------------------------------------------------------------------------

// Loads tile t's x patch into registers: patch (q, s) holds x at image row
// reflect1(r0-2+q) and column reflect1(c0-2+s) (clamped to [-1, n] first;
// positions beyond that are never read).
__device__ __forceinline__ void fetch_x(const float* __restrict__ x, int t, int ntiles,
                                        int tiles_x, int tiles_y, int H, int W,
                                        float (&pf)[kXPer]) {
  if (t >= ntiles) return;
  int b, r0, c0;
  tile_origin(t, kT, tiles_x, tiles_y, b, r0, c0);
  const float* xb = x + (size_t)b * H * W * 3;
#pragma unroll
  for (int k = 0; k < kXPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < kXElems) {
      const int ci = e % 3, p = e / 3, s = p % kXE, q = p / kXE;
      const int gr = reflect1(clampi(r0 - 2 + q, -1, H), H);
      const int gc = reflect1(clampi(c0 - 2 + s, -1, W), W);
      pf[k] = __ldg(xb + ((size_t)gr * W + gc) * 3 + ci);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
encode_head_kernel(const float* __restrict__ x, const float4* __restrict__ w1f,
                   const float* __restrict__ b1, const void* __restrict__ w2p,
                   const float* __restrict__ b2, float* __restrict__ out, int H, int W,
                   int tiles_x, int tiles_y, int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* halo = smem + kEncOffHalo;
  const uint32_t halo_s = smem_u32(halo);
  float* xs = reinterpret_cast<float*>(smem + kEncOffX);
  float4* w1s = reinterpret_cast<float4*>(smem + kEncOffW1);
  float* b1s = reinterpret_cast<float*>(smem + kEncOffB1);
  float* b2s = reinterpret_cast<float*>(smem + kEncOffB2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  Ring ring;
  ring.smem = smem_u32(smem);
  ring_start(ring, smem + kEncOffBar, w2p, my_tiles(ntiles));
  for (int i = tid; i < kEncW1Bytes / 16; i += kThreads) w1s[i] = w1f[i];
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }

  // This lane's 8 k indices of conv1's A fragments, [k-step][column t4 or
  // t4 + 4] (k = tap * 3 + ci, 27 real of 32), as offsets into the x patch;
  // -1 for the zero padding.
  int koff[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 8 * (i >> 1) + t4 + 4 * (i & 1), tap = k / 3;
    koff[i] = k < 27 ? ((tap / 3) * kXE + tap % 3) * 3 + k % 3 : -1;
  }

  const int hp = (H + 1) / 2, wp = (W + 1) / 2;
  float pf[kXPer];
  int tile = blockIdx.x;
  fetch_x(x, tile, ntiles, tiles_x, tiles_y, H, W, pf);

  for (; tile < ntiles; tile += gridDim.x) {
    int b, r0, c0;
    tile_origin(tile, kT, tiles_x, tiles_y, b, r0, c0);
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      const int e = tid + k * kThreads;
      if (e < kXElems) xs[e] = pf[k];
    }
    __syncthreads();  // x patch (and, once, the constants) ready; last tile's conv2 done
    fetch_x(x, tile + gridDim.x, ntiles, tiles_x, tiles_y, H, W, pf);

    // conv1 on the 18x18 halo of relu1_1, each position at its reflected
    // coordinate, on mma.sync.m16n8k8.tf32 with the three products: M = 324
    // halo pixels (21 m16 tiles), N = 64, K = 27 padded to 32. The patch is
    // stored reflected, so a tap of a reflected position is a fixed offset.
    for (int mt = warp; mt < kHaloTiles; mt += kWarps) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(mt * 16 + g + 8 * h, kHalo - 1);
        const int i = p / kE, j = p % kE;
        const int rr = reflect1(min(r0 - 1 + i, H), H);
        const int cc = reflect1(min(c0 - 1 + j, W), W);
        base[h] = ((rr + 1 - r0) * kXE + (cc + 1 - c0)) * 3;
      }
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ahi[4], alo[4];  // rows g, g + 8, g, g + 8; columns t4, t4, t4 + 4, t4 + 4
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = koff[2 * ks + (q >> 1)];
          const float v = o >= 0 ? xs[base[q & 1] + o] : 0.f;
          ahi[q] = tf32_rna(v);
          alo[q] = tf32_rna(v - __uint_as_float(ahi[q]));
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 bf = w1s[(ks * 8 + nt) * 32 + lane];  // hi b0, hi b1, lo b0, lo b1
          const uint32_t bh0 = __float_as_uint(bf.x), bh1 = __float_as_uint(bf.y);
          mma_tf32(acc[nt], alo, bh0, bh1);
          mma_tf32(acc[nt], ahi, __float_as_uint(bf.z), __float_as_uint(bf.w));
          mma_tf32(acc[nt], ahi, bh0, bh1);
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
            *reinterpret_cast<float2*>(halo + p * kPix + (((2 * nt + (t4 >> 1)) ^ sw) << 4) +
                                       (t4 & 1) * 8) =
                make_float2(fmaxf(acc[nt][2 * h] + b1s[ch], 0.f),
                            fmaxf(acc[nt][2 * h + 1] + b1s[ch + 1], 0.f));
          }
        }
      }
    }
    __syncthreads();  // relu1_1 halo ready

    // conv2: warp w owns output rows 2w (m16 tile 0) and 2w+1 (tile 1), all
    // 16 columns; row m of a tile is column 2 (m & 7) + (m >> 3).
    float tot[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) tot[mt][nt][0] = tot[mt][nt][1] = tot[mt][nt][2] = tot[mt][nt][3] = 0.f;
    const int m = lane & 15;
    const int colm = 2 * (m & 7) + (m >> 3);
    ring_conv(tot, ring, [&](int mt, int tap) {
      const int P = (2 * warp + mt + tap / 3) * kE + colm + tap % 3;
      return make_uint2(halo_s + P * kPix, (P >> 1) & 7);
    });

    // Bias, ReLU and the 2x2 ceil-mode pool over in-image taps, in registers.
    const int ra = r0 + 2 * warp, ca = c0 + 2 * g;
    if (ra < H && ca < W) {
      const bool r_ok = ra + 1 < H, c_ok = ca + 1 < W;
      float* o = out + (((size_t)b * hp + (r0 >> 1) + warp) * wp + (c0 >> 1) + g) * kC + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mx = tot[0][nt][e];                            // (ra, ca)
          if (c_ok) mx = fmaxf(mx, tot[0][nt][2 + e]);         // (ra, ca+1)
          if (r_ok) mx = fmaxf(mx, tot[1][nt][e]);             // (ra+1, ca)
          if (r_ok && c_ok) mx = fmaxf(mx, tot[1][nt][2 + e]);
          v[e] = fmaxf(mx + b2s[nt * 8 + 2 * t4 + e], 0.f);
        }
        *reinterpret_cast<float2*>(o + nt * 8) = make_float2(v[0], v[1]);
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
__device__ __forceinline__ void fetch_y(const float* __restrict__ y, uint32_t dst, int t,
                                        int ntiles, int tiles_x, int tiles_y, int h, int w) {
  if (t >= ntiles) return;
  int b, r0, c0;
  tile_origin(t, kOut, tiles_x, tiles_y, b, r0, c0);
  const int y0 = r0 / 2 - 1, x0 = c0 / 2 - 1;
  for (int i = threadIdx.x; i < kYE * kYE * 16; i += kThreads) {
    const int k = i & 15, q = i >> 4, a = q / kYE, c = q % kYE;
    const int yr = clampi(y0 + a, 0, h - 1), yc = clampi(x0 + c, 0, w - 1);
    cp_async16(dst + q * kPix + ((k ^ (q & 7)) << 4),
               y + (((size_t)b * h + yr) * w + yc) * kC + k * 4);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_tail_kernel(const float* __restrict__ y, const void* __restrict__ w2p,
                   const float* __restrict__ b2, const float* __restrict__ w1,
                   const float* __restrict__ b1, float* __restrict__ out, int h, int w,
                   int tiles_x, int tiles_y, int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* zs = smem + kDecOffZ;
  const uint32_t ys = smem_u32(smem + kDecOffY);
  const float4* w1s = reinterpret_cast<const float4*>(smem + kDecOffW1);
  float* b2s = reinterpret_cast<float*>(smem + kDecOffB2);
  float* b1s = reinterpret_cast<float*>(smem + kDecOffB1);

  const int H = 2 * h, W = 2 * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m = lane & 15;

  Ring ring;
  ring.smem = smem_u32(smem);
  ring_start(ring, smem + kDecOffBar, w2p, my_tiles(ntiles));
  for (int i = tid; i < kDecW1Floats; i += kThreads) reinterpret_cast<float*>(smem + kDecOffW1)[i] = w1[i];
  if (tid < kC) b2s[tid] = b2[tid];
  if (tid < 4) b1s[tid] = b1[tid];
  int tile = blockIdx.x;
  fetch_y(y, ys, tile, ntiles, tiles_x, tiles_y, h, w);
  cp_async_commit();

  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    int b, r0, c0;
    tile_origin(tile, kOut, tiles_x, tiles_y, b, r0, c0);
    fetch_y(y, ys + (buf ^ 1) * kYBytes, tile + gridDim.x, ntiles, tiles_x, tiles_y, h, w);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's y window ready; last tile's tail conv done

    // conv 64->64 on the 16x16 z halo: halo pixel (i, j) is z at (r0-1+i,
    // c0-1+j); tap (dy, dx) reads u at (r0-2+i+dy, c0-2+j+dx). Warp w owns
    // halo rows 2w (m16 tile 0) and 2w+1 (tile 1); row m of a tile is j = m.
    const uint32_t yb = ys + buf * kYBytes;
    const int y0 = r0 / 2 - 1, x0 = c0 / 2 - 1;
    float tot[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) tot[mt][nt][0] = tot[mt][nt][1] = tot[mt][nt][2] = tot[mt][nt][3] = 0.f;
    ring_conv(tot, ring, [&](int mt, int tap) {
      const int a = (clampi(r0 - 2 + 2 * warp + mt + tap / 3, 0, H - 1) >> 1) - y0;
      const int c = (clampi(c0 - 2 + m + tap % 3, 0, W - 1) >> 1) - x0;
      const int q = a * kYE + c;
      return make_uint2(yb + q * kPix, q & 7);
    });
    // relu(z) to shared memory, each value also to the border positions
    // that mirror it (z(-1) = z(1), z(H) = z(H-2); likewise columns, and the
    // corners from both), so no pass over the border follows. A border row
    // or column computes nothing of its own: its values come from the
    // mirror, each position written once.
    const int gi = H + 1 - r0, gj = W + 1 - c0;  // halo index of z row H / column W
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int i = 2 * warp + mt;
      if ((r0 == 0 && i == 0) || i == gi) continue;
      const int rows[3] = {i, (r0 == 0 && i == 2) ? 0 : -1, i == gi - 2 ? gi : -1};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = g + 8 * hh;
        if ((c0 == 0 && j == 0) || j == gj) continue;
        const int cols[3] = {j, (c0 == 0 && j == 2) ? 0 : -1, j == gj - 2 ? gj : -1};
        float2 v[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int ch = nt * 8 + 2 * t4;
          v[nt] = make_float2(fmaxf(tot[mt][nt][2 * hh] + b2s[ch], 0.f),
                              fmaxf(tot[mt][nt][2 * hh + 1] + b2s[ch + 1], 0.f));
        }
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            if (rows[a] < 0 || rows[a] >= kT || cols[e] < 0 || cols[e] >= kT) continue;
            const int p = rows[a] * kT + cols[e];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              *reinterpret_cast<float2*>(zs + p * kPix + (((2 * nt + (t4 >> 1)) ^ (p & 7)) << 4) +
                                         (t4 & 1) * 8) = v[nt];
          }
      }
    }
    __syncthreads();  // z halo written

    // conv 64->3 on the 14x14 output tile, fp32 FMAs: a warp takes pairs of
    // pixels, lane l sums input chunk l & 15 (4 channels) of pixel
    // l >> 4 over the 9 taps with its 108 weights in registers, and 16 lanes
    // reduce. A warp's z reads are two whole pixels (conflict-free).
    {
      const int c = lane & 15;
      float4 wr[9][3];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int o = 0; o < 3; ++o) wr[tap][o] = w1s[(tap * 16 + c) * 3 + o];
      // Two pairs a step (pairs q and q + 8), so that two reductions overlap.
      for (int q = warp; q < kOut * kOut / 2; q += 2 * kWarps) {
        float o[2][3] = {};
        int R[2], C[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int px = 2 * min(q + u * kWarps, kOut * kOut / 2 - 1) + (lane >> 4);
          const int i = px / kOut, j = px % kOut;
          R[u] = r0 + i;
          C[u] = c0 + j;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int p = (i + tap / 3) * kT + j + tap % 3;
            const float4 z =
                *reinterpret_cast<const float4*>(zs + p * kPix + ((c ^ (p & 7)) << 4));
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              o[u][k] = fmaf(z.x, wr[tap][k].x, o[u][k]);
              o[u][k] = fmaf(z.y, wr[tap][k].y, o[u][k]);
              o[u][k] = fmaf(z.z, wr[tap][k].z, o[u][k]);
              o[u][k] = fmaf(z.w, wr[tap][k].w, o[u][k]);
            }
          }
        }
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int k = 0; k < 3; ++k) o[u][k] += __shfl_xor_sync(0xffffffffu, o[u][k], off);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (c == 0 && q + u * kWarps < kOut * kOut / 2 && R[u] < H && C[u] < W) {
            float* dst = out + (((size_t)b * H + R[u]) * W + C[u]) * 3;
            dst[0] = o[u][0] + b1s[0];
            dst[1] = o[u][1] + b1s[1];
            dst[2] = o[u][2] + b1s[2];
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

cudaError_t launch_encode(const void* x, const void* w1, const void* b1, const void* w2p,
                          const void* b2, void* out, int B, int H, int W, cudaStream_t s) {
  const int tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;
  const long long ntiles = (long long)B * tiles_x * tiles_y;
  int grid = 0;
  cudaError_t e = grid_size(ntiles, grid);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(encode_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kEncSmem);
  if (e != cudaSuccess) return e;
  encode_head_kernel<<<grid, kThreads, kEncSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float4*>(w1), static_cast<const float*>(b1),
      w2p, static_cast<const float*>(b2), static_cast<float*>(out), H, W, tiles_x, tiles_y,
      (int)ntiles);
  return cudaGetLastError();
}

cudaError_t launch_decode(const void* y, const void* w2p, const void* b2, const void* w1,
                          const void* b1, void* out, int B, int h, int w, cudaStream_t s) {
  const int tiles_x = (2 * w + kOut - 1) / kOut, tiles_y = (2 * h + kOut - 1) / kOut;
  const long long ntiles = (long long)B * tiles_x * tiles_y;
  int grid = 0;
  cudaError_t e = grid_size(ntiles, grid);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(decode_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDecSmem);
  if (e != cudaSuccess) return e;
  decode_tail_kernel<<<grid, kThreads, kDecSmem, s>>>(
      static_cast<const float*>(y), w2p, static_cast<const float*>(b2),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<float*>(out), h,
      w, tiles_x, tiles_y, (int)ntiles);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a block of the head (0) or the tail (1): ptxas
// reports only static shared memory.
extern "C" int aip_adain_head_smem(int tail) { return tail ? kDecSmem : kEncSmem; }

// x [B,H,W,3] fp32 (H, W >= 2), out [B,ceil(H/2),ceil(W/2),64] fp32.
// w1f: conv1's B fragments, fp32 [4 k-steps][8 n-tiles][32 lanes][hi b0, hi
// b1, lo b0, lo b1] (the folded 3->64 weights, k = (dy*3+dx)*3 + ci, 27
// padded to 32); b1 [64] (folded); w2p: [9 taps][hi, lo][2 K-blocks][64 out][8 chunks ^ (out & 7)]
// [4 in] tf32 in fp32 words (32 KB a tap, 16-B aligned); b2 [64].
extern "C" int aip_encode_head(const void* x, const void* w1, const void* b1, const void* w2p,
                               const void* b2, void* out, int B, int H, int W, void* stream) {
  if (B < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  return (int)launch_encode(x, w1, b1, w2p, b2, out, B, H, W, static_cast<cudaStream_t>(stream));
}

// y [B,h,w,64] fp32 (h, w >= 1), out [B,2h,2w,3] fp32. w2p as above; b2
// [64]; w1 [9 taps][16 chunks of 4 in][3 out][4 in] fp32; b1 [4] (the 4th
// 0).
extern "C" int aip_decode_tail(const void* y, const void* w2p, const void* b2, const void* w1,
                               const void* b1, void* out, int B, int h, int w, void* stream) {
  if (B < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_decode(y, w2p, b2, w1, b1, out, B, h, w, static_cast<cudaStream_t>(stream));
}
