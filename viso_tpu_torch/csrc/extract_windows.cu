// Per-feature window extraction for Hopper (sm_90a): kernel K1.
//
// Replaces viso_tpu/geometry/extract_pallas.py::_kernel / _dma_extract,
// the TPU kernel that issued one HBM->HBM DMA per feature over a sliding
// wave of 128 semaphores and over-copied each window to an (8, 128)-
// aligned tile. Here every window is copied EXACTLY: out[i] is the
// (h, w) block of image k[i] (or of the single image) at origin (x0, y0).
// Three entries share one kernel:
//   * explicit origins base[i] (the stereo strip), with lax.dynamic_slice
//     semantics for the origin and for k: a negative index counts from the
//     end once, then it is clamped so the window fits (k to [0, K-1]);
//   * centred square windows: the kernel computes each origin once,
//     floor(c) - win / 2 clamped to [0, W - win] x [0, H - win], exactly as
//     torch computes it on the card (float -> int32 by cvt.rzi, so NaN
//     gives 0 and +-inf saturate; the subtraction wraps), and writes it out;
//   * two sources in one launch: n centred windows of a keyframe stack
//     (image k[i]), then n of the current image, so the caller (align) needs
//     no concatenated copy of the images.
//
// What bounds it on this card: almost nothing moves. The largest call on
// the stereo VO path (align: 2 x 1024 windows of 16 x 16 f32) reads and
// writes ~4 MB, about 1.3 us at 3.35 TB/s, near one launch (~1 us). So
// the kernel is bounded by launches and by the latency of short row reads
// from L2 (the source level was written just before), not by bandwidth.
// The design therefore adds no launches around the copy (the origins are
// computed in the kernel, the two sources need no concatenated copy) and
// keeps every load independent: one block per window, a thread per
// element for windows of at most kOneLoadElems elements and a thread per
// two elements above (up to kMaxThreads), neighbouring threads on
// neighbouring columns, no division per element, __ldg reads, default
// stores (the samplers read the windows right after). A warp per window
// with several windows per block and 4-8 loads per lane in flight measured
// slower at every main-path shape (tools/bench_k1.py): here more
// independent threads beat deeper per-thread queues. TMA cannot take
// these windows: its box rows must be multiples of 16 bytes (here 40, 48,
// 92 or 136) and start at a 16-byte aligned column (any column here).
//
// The kernel allocates nothing; the Python wrapper
// (viso_tpu_torch/geometry/extract.py) allocates the outputs, checks
// device, dtype, shape and contiguity, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;    // threads per window, at most
constexpr int kOneLoadElems = 160;  // windows this small get a thread per element

// lax.dynamic_slice's start index: a negative start counts from the end
// once (i + dim), then the start is clamped to [0, dim - size].
__device__ __forceinline__ int slice_start(int i, int dim, int size) {
  if (i < 0) i += dim;
  return min(max(i, 0), dim - size);
}

// extract.centered_base on the card: floor, cast to int32 (cvt.rzi: NaN
// -> 0, +-inf and out-of-range values saturate), subtract half with
// int32 wrap-around (done unsigned, so it is defined), clamp to [0, hi].
__device__ __forceinline__ int centred_start(float c, int half, int hi) {
  const int f = __float2int_rz(floorf(c));
  const int b = static_cast<int>(static_cast<unsigned>(f) - static_cast<unsigned>(half));
  return min(max(b, 0), hi);
}

// One source of windows: n windows of img (K images of H x W), window j
// from image kidx[j] (or image 0), origin from centers[j] (centred) or
// base[j] (explicit).
struct Source {
  const float* img;
  int K;
  const int* kidx;
  const float* centers;
  const int* base;
  int n;
};

template <bool kCentred>
__global__ void __launch_bounds__(kMaxThreads) extract_windows_kernel(
    Source a, Source b, int H, int W, int h, int w, int dr, int dc,
    float* __restrict__ out, int* __restrict__ base_out) {
  const int i = blockIdx.x;   // one window per block
  const bool in_a = i < a.n;
  const int j = in_a ? i : i - a.n;
  const float* img = in_a ? a.img : b.img;
  const int K = in_a ? a.K : b.K;
  const int* kidx = in_a ? a.kidx : b.kidx;
  int x0, y0;
  if (kCentred) {
    const float* ctr = in_a ? a.centers : b.centers;
    x0 = centred_start(__ldg(ctr + 2 * j), w / 2, W - w);
    y0 = centred_start(__ldg(ctr + 2 * j + 1), h / 2, H - h);
    if (threadIdx.x == 0) {
      base_out[2 * i] = x0;
      base_out[2 * i + 1] = y0;
    }
  } else {
    const int* base = in_a ? a.base : b.base;
    x0 = slice_start(__ldg(base + 2 * j), W, w);
    y0 = slice_start(__ldg(base + 2 * j + 1), H, h);
  }
  const int k = kidx != nullptr ? slice_start(__ldg(kidx + j), K, 1) : 0;
  const float* src =
      img + (static_cast<int64_t>(k) * H + y0) * static_cast<int64_t>(W) + x0;
  float* dst = out + static_cast<int64_t>(i) * h * w;

  // Thread t copies elements e = t, t + blockDim.x, ... of the window in
  // row-major order: neighbouring threads read neighbouring columns and
  // write neighbouring words. (r, c) of e steps by (dr, dc) = (blockDim.x
  // / w, blockDim.x % w), computed on the host: one division per thread,
  // none per element.
  const int total = h * w;
  int r = threadIdx.x / w, c = threadIdx.x - r * w;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    dst[e] = __ldg(src + static_cast<int64_t>(r) * W + c);
    c += dc;
    r += dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

int launch(bool centred, const Source& a, const Source& b, int H, int W,
           int h, int w, float* out, int* base_out, void* stream) {
  const int total = a.n + b.n;
  if (total > 0) {
    // One block per window: a thread per element for the smallest windows,
    // else a thread per two elements, at most kMaxThreads (measured on the
    // H100 with tools/bench_k1.py: two loads per thread beat one from
    // 16 x 16 up).
    const int hw = h * w;
    int threads = hw <= kOneLoadElems ? (hw + 31) / 32 * 32 : (hw / 2 + 31) / 32 * 32;
    threads = threads > kMaxThreads ? kMaxThreads : threads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (centred) {
      extract_windows_kernel<true><<<total, threads, 0, s>>>(a, b, H, W, h, w, threads / w,
                                                        threads % w, out, base_out);
    } else {
      extract_windows_kernel<false><<<total, threads, 0, s>>>(a, b, H, W, h, w, threads / w,
                                                        threads % w, out, base_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Explicit origins: out (N, h, w) from img (K, H, W) at base (N, 2),
// image kidx[n] (kidx null for one image).
extern "C" int viso_extract_windows(
    const float* img, int K, int H, int W,
    const int* base, const int* kidx, int N,
    int h, int w, float* out, void* stream) {
  const Source a{img, K, kidx, nullptr, base, N};
  const Source none{nullptr, 1, nullptr, nullptr, nullptr, 0};
  return launch(false, a, none, H, W, h, w, out, nullptr, stream);
}

// Centred win x win windows: N of img (K, H, W) (image kidx[n]; kidx null
// for one image) at centers (N, 2), then N2 of img2 (H, W) at centers2
// (N2, 2). Writes out (N + N2, win, win) and base_out (N + N2, 2).
extern "C" int viso_extract_centered(
    const float* img, int K, int H, int W, const int* kidx,
    const float* centers, int N, const float* img2, const float* centers2,
    int N2, int win, float* out, int* base_out, void* stream) {
  const Source a{img, K, kidx, centers, nullptr, N};
  const Source b{img2, 1, nullptr, centers2, nullptr, N2};
  return launch(true, a, b, H, W, win, win, out, base_out, stream);
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// An empty kernel: the card's launch floor, timed beside the copy.
extern "C" int viso_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
