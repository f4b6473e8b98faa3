// K-WF: |X|^2 + IQ display roll + int8-dB waterfall pyramid.
//
// Replaces the Pallas kernel fused_waterfall_pyramid
// (phantomsdr_tpu/ops/pallas/waterfall.py) and, on the main path, the
// spectrum_power / roll_iq steps in front of it: the kernel reads the
// complex64 spectra of the cadence-due hops directly (row indices given,
// no gather of the [B, R] spectrum), applies the roll j -> (j + roll) % R
// by index, and writes the flat [D, P] int8 pyramid
// (level l at offset sum_{i<l} R >> i = 2 (R - (R >> l)), width R >> l).
//
// Bound: bytes.  It reads 8 bytes per bin of each due row and writes
// ~2 bytes per bin.  The quantization costs nearly as much: about two
// outputs per input bin, each a log2, and libdevice's accurate log2f is
// a polynomial (no MUFU op).  On an H100 a copy of this kernel with
// log2f for every output takes about 1.5x the time of one with no log2
// at all (tools/torch_kernel_breakdown.py, wf_variants).  So:
//
// - chunk_pyramid_kernel (rows of 2048 bins or more, the main path): one
//   block per 2048 display bins of a row, 8 warps.  Lane t of warp w owns
//   the 8 consecutive bins base + 256 w + 8 t.  It issues its four
//   16-byte loads (streaming, evict-first: the spectra are read once)
//   before any use, squares in registers and pair-sums there for levels
//   1-3 (8 -> 1 bin), then levels 4-8 by shuffles between lanes (xor 1,
//   2, 4, 8, 16: every lane of a group ends with the group's sum), levels
//   9-11 through one exchange in shared memory among the block's warps.
//   Levels 0-2 go out as one 8-, 4- or 2-byte store a lane; the 31 bins
//   of levels 4-8 are gathered one to a lane and quantized by one log2 a
//   lane, likewise the 7 of levels 9-11.
// - quantize() takes log2 from lg2.approx (one MUFU op) and keeps the
//   result unless the dB value lies within 2^-10 of an integer, where
//   truncation could go either way, or p is subnormal: there the
//   accurate log2f decides.  The two dB values differ by less than
//   3.2e-4 (lg2.approx: 2^-22 absolute in [0.5, 2], else 2 ulp; log2f:
//   1 ulp; times 6.02, plus three roundings each of at most 3e-5 in both
//   paths), so the int8 equals the accurate one on every input.
// - The roll is odd on IQ rows (N/2 + 1) and real rows have N/2 + 1
//   bins, so a lane's 8 bins can start 8 bytes past a 16-byte boundary:
//   the lane then loads the aligned superset (one pair early) and takes
//   its 8th pair from the next lane's first, by shuffle.  The lane whose
//   bins wrap at R - roll reads pair by pair.  An output row that is not
//   aligned (P odd) stores byte by byte.
// - tile_pyramid_kernel: rows narrower than one chunk, and the passes
//   over per-chunk sums of a pyramid deeper than 12 levels.  One block
//   per tile; levels halve in shared memory.
//
// Arithmetic uses explicit round-to-nearest intrinsics (no FMA
// contraction) and the plain version's p[2j] + p[2j+1] tree (a shuffle
// sum a + b equals b + a), so the kernel equals the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kPerLane = 8;       // bins a lane owns in chunk_pyramid_kernel
constexpr int kChunkLog2 = 11;    // 8 warps x 32 lanes x 8 bins
constexpr int kMaxTileLog2 = 11;
constexpr float kEdgeDb = 0.0009765625f;   // 2^-10: see quantize()

__device__ __forceinline__ float db_of(float log2p, float l2db, float off_db) {
    return __fadd_rn(__fadd_rn(__fmul_rn(log2p, l2db), 127.0f), off_db);
}

// sat_trunc(log2(p) * l2db + 127 + off_db) as int8, -128 for p <= 0 or
// NaN; equal to the same expression with the accurate log2f
__device__ __forceinline__ int8_t quantize(float p, float l2db, float off_db) {
    if (!(p > 0.0f)) return -128;
    float lg;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(p));
    float db = db_of(lg, l2db, off_db);
    if (p < 1.17549435e-38f || fabsf(db - rintf(db)) < kEdgeDb) db = db_of(log2f(p), l2db, off_db);
    db = fminf(fmaxf(truncf(db), -128.0f), 127.0f);
    return static_cast<int8_t>(db);
}

__device__ __forceinline__ float level_db(int size_log2, int lev, float dpo) {
    return __fmul_rn(static_cast<float>(size_log2 - lev), dpo);
}

// sum_{i<lev} r >> i, for r a power of two and lev <= log2 r
__device__ __forceinline__ long long level_offset(long long r, int lev) {
    return 2 * (r - (r >> lev));
}

// Quantize p[0..N) and write the N bytes at dst: one N-byte store where
// dst is N-aligned, else byte stores (uniform over an output row).
template <int N>
__device__ __forceinline__ void emit(int8_t* dst, const float* p, float l2db,
                                     float off_db) {
    uint32_t w[(N + 3) / 4] = {};
#pragma unroll
    for (int i = 0; i < N; ++i)
        w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                        quantize(p[i], l2db, off_db))) << (8 * (i % 4));
    if ((reinterpret_cast<uintptr_t>(dst) & (N - 1)) == 0) {
        if constexpr (N == 8) {
            *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        } else if constexpr (N == 4) {
            *reinterpret_cast<uint32_t*>(dst) = w[0];
        } else if constexpr (N == 2) {
            *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(w[0]);
        } else {
            *dst = static_cast<int8_t>(w[0]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i)
            dst[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
    }
}

template <int N>
__device__ __forceinline__ void halve(float* p) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) p[i] = __fadd_rn(p[2 * i], p[2 * i + 1]);
}

// Levels lo .. lo + log2 N (up to last) by xor shuffles over groups of
// 2, 4, ... lanes, from one value a lane at level lo - 1; returns the
// last sum (every lane of a group holds it).  Level lo + i has N >> i
// bins, gathered into lanes [2N - 2 (N >> i), ...) as (c, level k,
// index m), which the caller quantizes with one log2 a lane.
template <int N>
__device__ __forceinline__ float shuffle_levels(float sum, int lo, int last, int lane,
                                                float& c, int& k, int& m) {
#pragma unroll
    for (int i = 0; (N >> i) > 0; ++i) {
        if (lo + i > last) break;
        sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, 1 << i));
        const int size = N >> i;
        const int at = lane - (2 * N - 2 * size);
        const float got = __shfl_sync(kFull, sum, (at & (size - 1)) << (i + 1));
        if (at >= 0 && at < size) {
            c = got;
            k = lo + i;
            m = at;
        }
    }
    return sum;
}

__global__ void __launch_bounds__(kThreads)
chunk_pyramid_kernel(const float2* __restrict__ spec, long long row_stride,
                     const int* __restrict__ rows, int r, int roll, int last,
                     int size_log2, float l2db, float dpo,
                     int8_t* __restrict__ out, long long out_row_stride,
                     float* __restrict__ tail) {
    __shared__ float warp_sum[kThreads / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int d = blockIdx.y;
    const int chunk0 = blockIdx.x << kChunkLog2;
    const int j0 = chunk0 + static_cast<int>(threadIdx.x) * kPerLane;
    const float2* s = spec + static_cast<long long>(rows[d]) * row_stride;
    int8_t* o = out + static_cast<long long>(d) * out_row_stride;

    // e[k] = s[a + k]; the lane's bins are e[shift .. shift + 7]
    int g0 = j0 + roll;
    if (g0 >= r) g0 -= r;
    const bool fast = g0 + kPerLane <= r;
    const int shift = fast ? static_cast<int>((reinterpret_cast<uintptr_t>(s + g0) >> 3) & 1)
                           : 0;
    const int a = fast ? g0 - shift : -1;
    float2 e[kPerLane + 1];
    if (fast) {
        const float4* q = reinterpret_cast<const float4*>(s + a);
        float4 x[kPerLane / 2];
#pragma unroll
        for (int i = 0; i < kPerLane / 2; ++i) x[i] = __ldcs(q + i);
#pragma unroll
        for (int i = 0; i < kPerLane / 2; ++i) {
            e[2 * i] = make_float2(x[i].x, x[i].y);
            e[2 * i + 1] = make_float2(x[i].z, x[i].w);
        }
    } else {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
            int g = g0 + k;
            if (g >= r) g -= r;
            e[k] = __ldcs(s + g);
        }
    }
    // e[8]: the next lane's first pair where that lane loaded the pair
    // after this lane's, else read here
    const float nx = __shfl_down_sync(kFull, e[0].x, 1);
    const float ny = __shfl_down_sync(kFull, e[0].y, 1);
    const int na = __shfl_down_sync(kFull, a, 1);
    e[kPerLane] = !shift ? e[0]
                  : lane < 31 && na == a + kPerLane ? make_float2(nx, ny)
                                                    : __ldcs(s + a + kPerLane);

    float p[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
        const float2 v = shift ? e[k + 1] : e[k];
        p[k] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    }

    const long long rl = r;
    emit<8>(o + j0, p, l2db, level_db(size_log2, 0, dpo));
    if (last < 1) return;
    halve<8>(p);
    emit<4>(o + level_offset(rl, 1) + (j0 >> 1), p, l2db, level_db(size_log2, 1, dpo));
    if (last < 2) return;
    halve<4>(p);
    emit<2>(o + level_offset(rl, 2) + (j0 >> 2), p, l2db, level_db(size_log2, 2, dpo));
    if (last < 3) return;
    halve<2>(p);
    emit<1>(o + level_offset(rl, 3) + (j0 >> 3), p, l2db, level_db(size_log2, 3, dpo));
    if (last < 4) return;

    // levels 4-8: 16 + 8 + 4 + 2 + 1 bins of the warp, one to a lane
    float c = 0.0f;
    int ck = 0, cm = 0;
    const float wsum = shuffle_levels<16>(p[0], 4, last, lane, c, ck, cm);
    if (ck > 0) {
        const int w0 = chunk0 + (warp << 8);
        o[level_offset(rl, ck) + (w0 >> ck) + cm] =
            quantize(c, l2db, level_db(size_log2, ck, dpo));
    }
    if (last < 9) return;

    // levels 9-11: the 8 warps' sums, 4 + 2 + 1 bins, in warp 0
    if (lane == 0) warp_sum[warp] = wsum;
    __syncthreads();
    if (warp != 0) return;
    ck = 0;
    const float bsum = shuffle_levels<4>(warp_sum[lane & 7], 9, last, lane, c, ck, cm);
    if (ck > 0)
        o[level_offset(rl, ck) + (chunk0 >> ck) + cm] =
            quantize(c, l2db, level_db(size_log2, ck, dpo));
    if (tail != nullptr && lane == 0)
        tail[static_cast<long long>(d) * gridDim.x + blockIdx.x] = bsum;
}

// src: COMPLEX ? float2 spectra rows (rows[d] * row_stride) : float power
// rows (d * row_stride).  The pass covers levels first..last of the
// pyramid and writes those >= emit_from.  tail (optional) receives each
// tile's power at level `last`.
template <bool COMPLEX>
__global__ void __launch_bounds__(kThreads)
tile_pyramid_kernel(const void* __restrict__ src, long long row_stride,
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
            const float off_db = level_db(size_log2, lev, dpo);
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
// int8; scratch: 2 * num_rows * (r >> 11) floats, needed only when the
// pyramid is deeper than one chunk (levels > 12).
extern "C" int waterfall_launch(const void* spec, long long row_stride,
                                const int* rows, int num_rows, int r, int roll,
                                int levels, int size_log2, float l2db, float dpo,
                                int8_t* out, long long out_row_stride,
                                float* scratch, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_rows == 0) return 0;

    int last;
    if (ilog2(r) >= kChunkLog2) {
        last = levels - 1 < kChunkLog2 ? levels - 1 : kChunkLog2;
        dim3 grid(r >> kChunkLog2, num_rows);
        chunk_pyramid_kernel<<<grid, kThreads, 0, s>>>(
            static_cast<const float2*>(spec), row_stride, rows, r, roll, last,
            size_log2, l2db, dpo, out, out_row_stride,
            last < levels - 1 ? scratch : nullptr);
    } else {
        // a row narrower than a chunk holds every level it can have
        last = levels - 1;
        dim3 grid(1, num_rows);
        tile_pyramid_kernel<true><<<grid, kThreads, 0, s>>>(
            spec, row_stride, rows, r, roll, ilog2(r), 0, last, 0, r, size_log2,
            l2db, dpo, out, out_row_stride, nullptr);
    }

    // coarse levels beyond one chunk: passes over the per-chunk sums
    float* in = scratch;
    float* next = scratch + static_cast<long long>(num_rows) * (r >> last);
    while (last < levels - 1) {
        const int width = r >> last;
        const int first = last;
        const int tile_log2 = ilog2(width) < kMaxTileLog2 ? ilog2(width) : kMaxTileLog2;
        last = levels - 1 < first + tile_log2 ? levels - 1 : first + tile_log2;
        dim3 g(width >> tile_log2, num_rows);
        tile_pyramid_kernel<false><<<g, kThreads, 0, s>>>(
            in, width, nullptr, width, 0, tile_log2, first, last, first + 1, r,
            size_log2, l2db, dpo, out, out_row_stride,
            last < levels - 1 ? next : nullptr);
        float* t = in;
        in = next;
        next = t;
    }
    return static_cast<int>(cudaGetLastError());
}
