// K-WF: |X|^2 + IQ display roll + int8-dB waterfall pyramid.
//
// Replaces the Pallas kernel fused_waterfall_pyramid
// (phantomsdr_tpu/ops/pallas/waterfall.py) and, on the main path, the
// spectrum_power / roll_iq steps in front of it: the kernel reads the
// complex64 spectra of the cadence-due hops directly (row indices given,
// no gather of the [B, R] spectrum), applies the roll j -> (j + roll) % R
// by index, and writes the flat [D, P] int8 pyramid
// (level l at offset sum_{i<l} R >> i, width R >> l).
//
// One block per (tile of T bins, row).  The block squares its tile into
// shared memory, quantizes level 0, pair-halves p[2j] + p[2j+1] in
// shared memory and repeats, so the power never goes back to device
// memory.  With T = 2^11 a tile holds 12 levels; a deeper pyramid (or a
// row narrower than its level count) hands each tile's last power to a
// further pass over the per-tile sums (same kernel, float input).
//
// Bound: bytes.  It reads 8 bytes per bin of each due row and writes
// ~2 bytes per bin; the log2 and the pair sums are a few operations per
// byte.  Arithmetic uses explicit round-to-nearest intrinsics (no FMA
// contraction) so it matches the plain PyTorch version, which computes
// each product and sum as its own float32 operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileLog2 = 11;

__device__ __forceinline__ int8_t quantize(float p, float l2db, float off_db) {
    if (!(p > 0.0f)) return -128;
    float db = __fadd_rn(__fadd_rn(__fmul_rn(log2f(p), l2db), 127.0f), off_db);
    db = fminf(fmaxf(truncf(db), -128.0f), 127.0f);
    return static_cast<int8_t>(db);
}

__host__ __device__ __forceinline__ long long level_offset(long long r, int lev) {
    long long off = 0;
    for (int i = 0; i < lev; ++i) off += r >> i;
    return off;
}

// src: COMPLEX ? float2 spectra rows (rows[d] * row_stride) : float power
// rows (d * row_stride).  The pass covers levels first..last of the
// pyramid and writes those >= emit_from.  tail (optional) receives each
// tile's power at level `last`.
template <bool COMPLEX>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const void* __restrict__ src, long long row_stride,
               const int* __restrict__ rows, int width, int roll,
               int tile_log2, int first, int last, int emit_from,
               long long r_full, int size_log2, float l2db, float dpo,
               int8_t* __restrict__ out, long long out_row_stride,
               float* __restrict__ tail) {
    __shared__ float sa[1 << kMaxTileLog2];
    __shared__ float sb[1 << (kMaxTileLog2 - 1)];
    const int tsize = 1 << tile_log2;
    const int tile = blockIdx.x;
    const int d = blockIdx.y;
    const long long base = static_cast<long long>(tile) * tsize;

    if (COMPLEX) {
        const float2* s = static_cast<const float2*>(src)
                          + static_cast<long long>(rows[d]) * row_stride;
        for (int j = threadIdx.x; j < tsize; j += kThreads) {
            long long g = base + j + roll;
            if (g >= width) g -= width;
            const float2 v = s[g];
            sa[j] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
        }
    } else {
        const float* s = static_cast<const float*>(src)
                         + static_cast<long long>(d) * row_stride;
        for (int j = threadIdx.x; j < tsize; j += kThreads) sa[j] = s[base + j];
    }
    __syncthreads();

    float* cur = sa;
    float* nxt = sb;
    int w = tsize;
    for (int lev = first;; ++lev) {
        if (lev >= emit_from) {
            const float off_db = __fmul_rn(static_cast<float>(size_log2 - lev), dpo);
            int8_t* o = out + static_cast<long long>(d) * out_row_stride
                        + level_offset(r_full, lev) + static_cast<long long>(tile) * w;
            for (int j = threadIdx.x; j < w; j += kThreads) o[j] = quantize(cur[j], l2db, off_db);
        }
        if (lev == last) break;
        for (int j = threadIdx.x; j < w / 2; j += kThreads)
            nxt[j] = __fadd_rn(cur[2 * j], cur[2 * j + 1]);
        __syncthreads();
        float* t = cur;
        cur = nxt;
        nxt = t;
        w /= 2;
    }
    if (tail != nullptr) {
        float* t = tail + static_cast<long long>(d) * (width >> (last - first))
                   + static_cast<long long>(tile) * w;
        for (int j = threadIdx.x; j < w; j += kThreads) t[j] = cur[j];
    }
}

int ilog2(long long v) {
    int l = 0;
    while ((1LL << (l + 1)) <= v) ++l;
    return l;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// spec: [*, row_stride] complex64; rows: [num_rows] int32 row indices;
// r: bins per row used (power of two); out: [num_rows, out_row_stride]
// int8; scratch: 2 * num_rows * (r >> min(levels-1, 11)) floats, needed
// only when the pyramid is deeper than one tile.
extern "C" int waterfall_launch(const void* spec, long long row_stride,
                                const int* rows, int num_rows, int r, int roll,
                                int levels, int size_log2, float l2db, float dpo,
                                int8_t* out, long long out_row_stride,
                                float* scratch, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_rows == 0) return 0;

    int tile_log2 = ilog2(r) < kMaxTileLog2 ? ilog2(r) : kMaxTileLog2;
    int last = levels - 1 < tile_log2 ? levels - 1 : tile_log2;
    float* tail = last < levels - 1 ? scratch : nullptr;
    dim3 grid(r >> tile_log2, num_rows);
    pyramid_kernel<true><<<grid, kThreads, 0, s>>>(
        spec, row_stride, rows, r, roll, tile_log2, 0, last, 0, r, size_log2,
        l2db, dpo, out, out_row_stride, tail);

    // coarse levels beyond one tile: passes over the per-tile sums
    float* in = scratch;
    float* next = scratch + static_cast<long long>(num_rows) * (r >> last);
    while (last < levels - 1) {
        const int width = r >> last;
        const int first = last;
        tile_log2 = ilog2(width) < kMaxTileLog2 ? ilog2(width) : kMaxTileLog2;
        last = levels - 1 < first + tile_log2 ? levels - 1 : first + tile_log2;
        dim3 g(width >> tile_log2, num_rows);
        pyramid_kernel<false><<<g, kThreads, 0, s>>>(
            in, width, nullptr, width, 0, tile_log2, first, last, first + 1, r,
            size_log2, l2db, dpo, out, out_row_stride,
            last < levels - 1 ? next : nullptr);
        float* t = in;
        in = next;
        next = t;
    }
    return static_cast<int>(cudaGetLastError());
}
