// The fp32 3x3 convs of the VGG encoder's and the AdaIN decoder's walks on
// Hopper's tensor cores (sm_90a), fp32-accurate.
//
// Replaces no Pallas kernel: the JAX package leaves these convs to XLA. On
// the card cuDNN computed them (TF32 off), and for some shapes it chose an
// FFT convolution of tens of thousands of tiny launches: the decoder's
// 256->128 conv at 1 x 128x171 issued 33,034 launches and took 108 ms of a
// 137 ms request. This kernel computes every such conv in one launch.
//
//   x   [B, H+2, W+2, Cin]  fp32 NHWC, the input with its reflection border
//   out [B, H, W, Cout]     fp32 NHWC, the conv without its bias (the walk's
//                           op chain adds the bias, ReLU, pool or upsample
//                           and the next border)
//   Cin, Cout multiples of 64.
//
// What bounds it on the H100: operations. A walk conv does 2 x 9 x Cin
// multiply-adds a output value (1.2-4.7 k) against 4 bytes in and 4 out. On
// the CUDA cores (67 TFLOP/s) a request's walks (about 390 GFLOP) take at
// least 5.8 ms; as three TF32 products at 495 TFLOP/s, at least 2.4 ms.
//
// Design (the 64->64 conv of adain_head.cu, generalised):
//   * Implicit GEMM on wgmma.m64n64k8.tf32. M is output pixels: a tile of
//     8 x MT rows by 16 columns (MT = 2: 256 pixels, two warpgroups of two
//     m64 tiles; MT = 1: 128 pixels, where the finer grid's waves over the
//     SMs take less time, as kernels/conv3x3_f32.py's tile_rows picks),
//     N is 64 output channels, K is 9 taps x Cin. A block walks (tile,
//     64-channel slice of Cout) items, persistent, one block an SM.
//   * Three TF32 products a multiply-add: each operand split, hi =
//     cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi); lo*Bhi + hi*Blo + hi*Bhi.
//     A (activations) is split in registers after ldmatrix reads it from an
//     fp32 window in shared memory; B (weights) arrives split and packed on
//     the host, once a module.
//   * Accuracy: the tensor cores round each step's fp32 sum toward zero, so
//     every (tap, 32 input channels) starts a fresh partial sum (12 wgmma
//     steps a m64 tile), which the CUDA cores add to a total in registers,
//     compensated (Kahan; the compensation as bf16, two a register): up to
//     72 partials a total, whose fp32 adds otherwise lose as much as the
//     truncated steps. On the walks' shapes a partial over 64 channels (24
//     steps, as adain_head.cu's taps) read 4.7-6.8e-7 of the largest output
//     from float64, over 32 channels uncompensated 3.1-5.8e-7, both farther
//     than cuDNN's FFT conv on the decoder's 256->128 (4.8e-7).
//   * Input: K runs over 64-channel chunks of Cin; for each, the tile's
//     (8 MT + 2) x 18 window of those channels (256 B a pixel, 16-byte
//     chunks XOR-swizzled by pixel so ldmatrix's 8 rows hit distinct banks)
//     is copied with cp.async into one of two buffers, the next chunk's (or
//     the next item's first) in flight while this one computes.
//   * Weights: packed [Cout/64][Cin/64][9 taps][2 halves of 32 input
//     channels][hi, lo][64 out][8 chunks ^ (out & 7)][4 in], 16 KB a (tap,
//     half): a K-major 64 x 32 tile in the 128-byte swizzle wgmma's
//     descriptor reads. They stream through a ring of 3 stages, one bulk
//     copy (TMA) a stage completing on an mbarrier; the last warp done with
//     a stage refills it. Every block of a Cout slice reads the same bytes,
//     which L2 holds.
//   * Shared memory (MT = 2): 48 KB of ring, 2 x 81 KB of window.
//
// Interface: plain C, loaded with ctypes. Every pointer is a device pointer,
// the stream is a cudaStream_t; the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kC = 64;                        // channels of a window chunk; N of a block
constexpr int kPix = kC * 4;                  // bytes of one pixel of a window chunk
constexpr int kTW = 16;                       // tile width: a warp's m16 rows
constexpr int kWE = kTW + 2;                  // window width
constexpr int kBlockBytes = kC * 32 * 4;      // 8192: a K-major 64 x 32 fp32 B tile
constexpr int kStageBytes = 2 * kBlockBytes;  // hi + lo of a (tap, 32 input channels)
constexpr int kStages = 3;
constexpr int kRingBytes = kStages * kStageBytes;

template <int MT>
struct Layout {
  static constexpr int rows = 8 * MT;                         // tile height
  static constexpr int win_px = (rows + 2) * kWE;
  static constexpr int win_bytes = win_px * kPix;
  static constexpr int off_win = kRingBytes;
  static constexpr int off_bar = off_win + 2 * win_bytes;
  static constexpr int smem = off_bar + 64 + 1024;            // + alignment slack
};

static_assert(Layout<2>::smem <= 232448 && Layout<1>::smem <= 232448, "shared memory per block");
static_assert(Layout<2>::off_bar % 8 == 0 && Layout<1>::off_bar % 8 == 0, "mbarrier alignment");

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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
}

// ---------------------------------------------------------------------------
// The weight ring: this block's (item, chunk, tap, half) stages in order
// ---------------------------------------------------------------------------

struct Ring {
  uint32_t smem;            // kStages x kStageBytes, 1024-B aligned
  uint32_t full;            // kStages mbarriers, 8 B apart: a stage has landed
  unsigned* done;           // kStages counters: warps done with a stage
  const unsigned char* w;   // the packed weights in device memory
  int next;                 // this block's next stage
  int total;                // stages of all this block's items
  int per_item;             // stages an item: Cin/64 x 9 x 2
  int slices;               // Cout / 64
};

// Stage g of this block's sequence into its slot (one thread).
__device__ __forceinline__ void ring_issue(const Ring& r, int g) {
  const int s = g % kStages;
  const uint32_t bar = r.full + 8 * s;
  const int item = (int)blockIdx.x + (g / r.per_item) * (int)gridDim.x;
  const size_t src = ((size_t)(item % r.slices) * r.per_item + g % r.per_item) * kStageBytes;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(kStageBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(r.smem + s * kStageBytes), "l"(r.w + src), "r"(kStageBytes), "r"(bar) : "memory");
}

// Initialises the ring's barriers and issues its first stages; the caller
// synchronises the block before the first wait.
__device__ __forceinline__ void ring_start(Ring& r, unsigned char* bars) {
  r.full = smem_u32(bars);
  r.done = reinterpret_cast<unsigned*>(bars + 8 * kStages);
  r.next = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(r.full + 8 * s) : "memory");
      r.done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < kStages && g < r.total; ++g) ring_issue(r, g);
  }
}

// Waits for stage g; returns the descriptor of its hi tile.
__device__ __forceinline__ uint64_t ring_wait(const Ring& r, int g) {
  const int s = g % kStages;
  mbar_wait(r.full + 8 * s, (g / kStages) & 1);
  return sw128_desc(r.smem + s * kStageBytes);
}

// This warp is done with stage g; the last of the 8 warps refills its slot
// with stage g + kStages.
__device__ __forceinline__ void ring_release(const Ring& r, int g) {
  if ((threadIdx.x & 31) == 0 && atomicInc(r.done + g % kStages, kWarps - 1) == kWarps - 1 &&
      g + kStages < r.total)
    ring_issue(r, g + kStages);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Items and windows
// ---------------------------------------------------------------------------

struct Shape {
  int H, W, cin, cout;      // output size; channels
  int tiles_x, tiles_y;     // tiles an image
  int slices;               // Cout / 64
  int chunks;               // Cin / 64
};

// Item -> (image, first output row, first column, Cout slice).
template <int MT>
__device__ __forceinline__ void item_origin(const Shape& sh, int item, int& b, int& r0, int& c0,
                                            int& n) {
  n = item % sh.slices;
  const int t = item / sh.slices, per = sh.tiles_x * sh.tiles_y;
  b = t / per;
  const int rem = t - b * per;
  r0 = (rem / sh.tiles_x) * Layout<MT>::rows;
  c0 = (rem % sh.tiles_x) * kTW;
}

// Issues the cp.async copies of a window: 64 channels from `chunk` of the
// bordered input at rows r0 .. r0 + rows + 1 and columns c0 .. c0 + 17
// (clamped to the input; a clamped pixel feeds only outputs past the edge,
// which are not stored). Pixel q's 16-byte chunk k lives at k ^ (q & 7).
template <int MT>
__device__ __forceinline__ void fetch_window(const float* __restrict__ x, const Shape& sh,
                                             uint32_t dst, int item, int chunk) {
  int b, r0, c0, n;
  item_origin<MT>(sh, item, b, r0, c0, n);
  const int hb = sh.H + 2, wb = sh.W + 2;
  const float* src = x + (size_t)b * hb * wb * sh.cin + chunk * kC;
  for (int i = threadIdx.x; i < Layout<MT>::win_px * 16; i += kThreads) {
    const int k = i & 15, q = i >> 4, a = q / kWE, c = q - a * kWE;
    const int gr = min(r0 + a, hb - 1), gc = min(c0 + c, wb - 1);
    cp_async16(dst + q * kPix + ((k ^ (q & 7)) << 4),
               src + ((size_t)gr * wb + gc) * sh.cin + k * 4);
  }
}

// tot += part, compensated (Kahan): comp holds, as two bf16 a register, what
// the fp32 adds have rounded away so far, with the opposite sign.
template <int MT>
__device__ __forceinline__ void add_partial(float (&tot)[MT][8][4], uint32_t (&comp)[MT][8][2],
                                            float (&part)[MT][8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162 cb = *reinterpret_cast<__nv_bfloat162*>(&comp[mt][nt][h]);
        float2 c = __bfloat1622float2(cb);
        float* cv[2] = {&c.x, &c.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& t = tot[mt][nt][2 * h + e];
          keep(part[mt][nt][2 * h + e]);
          const float y = part[mt][nt][2 * h + e] - *cv[e];
          const float s = t + y;
          *cv[e] = (s - t) - y;
          t = s;
        }
        cb = __floats2bfloat162_rn(c.x, c.y);
        comp[mt][nt][h] = *reinterpret_cast<uint32_t*>(&cb);
      }
}

// tot[mt] += this warp's rows of the conv over one 64-channel chunk: 9 taps
// x 8 k-steps of 8 channels, three TF32 products a step, a fresh partial
// sum a ring stage (a tap's 32 channels: 12 wgmma steps a m64 tile) added
// to tot on the CUDA cores (``add_partial``). The other warpgroup's
// products keep the tensor cores busy while one adds.
// Warp w's m16 tile mt is output row MT w + mt, its row m column m; lane
// reads pixel row lane & 15 and chunk half lane >> 4.
template <int MT>
__device__ __forceinline__ void conv_chunk(float (&tot)[MT][8][4], uint32_t (&comp)[MT][8][2],
                                           Ring& r, uint32_t win) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, half = lane >> 4, m = lane & 15;
  float part[MT][8][4];
  uint32_t hi[2][MT][4], lo[2][MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) hi[0][mt][q] = hi[1][mt][q] = lo[0][mt][q] = lo[1][mt][q] = 0u;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
  }
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    uint32_t arow[MT], asw[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int P = (MT * warp + mt + tap / 3) * kWE + m + tap % 3;
      arow[mt] = win + P * kPix;
      asw[mt] = P & 7;
    }
    const int g0 = r.next;
    r.next += 2;
    uint64_t desc0 = 0;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {  // k-step: channels 8 ks .. 8 ks + 7 of the chunk
      const int buf = ks & 1;
      if ((ks & 3) == 0) desc0 = ring_wait(r, g0 + (ks >> 2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
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
      const uint64_t dhi = desc0 + (uint64_t)(((ks & 3) * 32) >> 4);
      const uint64_t dlo = dhi + (uint64_t)(kBlockBytes >> 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wgmma_tf32(part[mt], lo[buf][mt], dhi, (ks & 3) > 0);  // a fresh partial a stage
        wgmma_tf32(part[mt], hi[buf][mt], dlo, 1);
        wgmma_tf32(part[mt], hi[buf][mt], dhi, 1);
      }
      wgmma_commit();
      if ((ks & 3) != 3) {
        wgmma_wait<1>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            keep(hi[buf ^ 1][mt][q]);
            keep(lo[buf ^ 1][mt][q]);
          }
        continue;
      }
      // The stage's 12 steps a m64 tile are done: its partial joins the total.
      wgmma_wait<0>();
      add_partial<MT>(tot, comp, part);
      ring_release(r, g0 + (ks >> 2));
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_f32_kernel(const float* __restrict__ x, const void* __restrict__ wp,
                   float* __restrict__ out, Shape sh, int nitems) {
  using L = Layout<MT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t win0 = smem_u32(smem + L::off_win);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int my_items =
      ((int)blockIdx.x < nitems) ? (nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = my_items * sh.chunks;   // (item, chunk) steps of this block

  Ring ring;
  ring.smem = smem_u32(smem);
  ring.w = static_cast<const unsigned char*>(wp);
  ring.per_item = sh.chunks * 18;
  ring.total = my_items * ring.per_item;
  ring.slices = sh.slices;
  ring_start(ring, smem + L::off_bar);
  if (steps > 0) fetch_window<MT>(x, sh, win0, blockIdx.x, 0);
  cp_async_commit();

  float tot[MT][8][4];
  uint32_t comp[MT][8][2];
  for (int s = 0; s < steps; ++s) {
    const int item = (int)blockIdx.x + (s / sh.chunks) * (int)gridDim.x;
    const int chunk = s % sh.chunks;
    if (s + 1 < steps)
      fetch_window<MT>(x, sh, win0 + ((s + 1) & 1) * L::win_bytes,
                       (int)blockIdx.x + ((s + 1) / sh.chunks) * (int)gridDim.x,
                       (s + 1) % sh.chunks);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this step's window landed (and, once, the ring's barriers exist)

    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          tot[mt][nt][0] = tot[mt][nt][1] = tot[mt][nt][2] = tot[mt][nt][3] = 0.f;
          comp[mt][nt][0] = comp[mt][nt][1] = 0u;
        }
    }
    conv_chunk<MT>(tot, comp, ring, win0 + (s & 1) * L::win_bytes);

    if (chunk == sh.chunks - 1) {
      int b, r0, c0, n;
      item_origin<MT>(sh, item, b, r0, c0, n);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int R = r0 + MT * warp + mt;
        if (R >= sh.H) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int C = c0 + g + 8 * hh;
          if (C >= sh.W) continue;
          float* o = out + (((size_t)b * sh.H + R) * sh.W + C) * sh.cout + n * kC + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 c =
                __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&comp[mt][nt][hh]));
            *reinterpret_cast<float2*>(o + nt * 8) =
                make_float2(tot[mt][nt][2 * hh] - c.x, tot[mt][nt][2 * hh + 1] - c.y);
          }
        }
      }
    }
    __syncthreads();  // every warp done with this step's window before it is refilled
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

template <int MT>
cudaError_t launch(const void* x, const void* wp, void* out, int B, int H, int W, int cin,
                   int cout, cudaStream_t stream) {
  Shape sh;
  sh.H = H;
  sh.W = W;
  sh.cin = cin;
  sh.cout = cout;
  sh.tiles_x = (W + kTW - 1) / kTW;
  sh.tiles_y = (H + Layout<MT>::rows - 1) / Layout<MT>::rows;
  sh.slices = cout / kC;
  sh.chunks = cin / kC;
  const long long nitems = (long long)B * sh.tiles_x * sh.tiles_y * sh.slices;
  if (nitems <= 0 || nitems * sh.chunks * 18 > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)(nitems < sms ? nitems : sms);
  cudaError_t e = cudaFuncSetAttribute(conv3x3_f32_kernel<MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Layout<MT>::smem);
  if (e != cudaSuccess) return e;
  conv3x3_f32_kernel<MT><<<grid, kThreads, Layout<MT>::smem, stream>>>(
      static_cast<const float*>(x), wp, static_cast<float*>(out), sh, (int)nitems);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a block of the MT-row-pair tiling (1 or 2):
// ptxas reports only static shared memory.
extern "C" int aip_conv3x3_f32_smem(int mt) { return mt == 1 ? Layout<1>::smem : Layout<2>::smem; }

// x [B,H+2,W+2,Cin] fp32 (the bordered input), wp the packed weights
// ([Cout/64][Cin/64][9][2][2][64][8][4] tf32 in fp32 words, 16-B aligned),
// out [B,H,W,Cout] fp32. Cin, Cout positive multiples of 64; mt the tile's
// m64 tiles a warpgroup: 2 (16 x 16 pixels) or 1 (8 x 16).
extern "C" int aip_conv3x3_f32(const void* x, const void* wp, void* out, int B, int H, int W,
                               int cin, int cout, int mt, void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < kC || cin % kC || cout < kC || cout % kC ||
      (mt != 1 && mt != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mt == 2 ? launch<2>(x, wp, out, B, H, W, cin, cout, s)
                       : launch<1>(x, wp, out, B, H, W, cin, cout, s));
}
