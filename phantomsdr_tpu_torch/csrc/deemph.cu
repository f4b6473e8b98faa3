// K-DEEMPH: FM de-emphasis, a one-pole IIR per stream row.
//
// Replaces the lax.associative_scan of deemph_process
// (phantomsdr_tpu/ops/deemph.py): per row r with mask[r] set,
//
//   y[n] = a * y[n-1] + (1 - a) * x[n],   y[-1] = y_prev[r]
//
// and y_out[r] = y[len-1]; a row with mask[r] clear is copied through
// (y = x) and keeps its carry.
//
// Bound: bytes.  The row is read once and written once (82 MB at the
// wideband WBFM step, [256, 40272] float32); the recurrence itself is
// two float32 operations a sample.
//
// Design: one block of 256 threads per row, walking the row in tiles of
// up to kTile samples staged in shared memory (coalesced loads and
// stores; a pad word every 32 floats keeps each thread's contiguous
// chunk of 32 conflict-free).  Per tile:
// 1. each thread runs its chunk from zero: B = the chunk's output for a
//    zero carry, A = a^len (the recurrence is affine in its carry:
//    y_end = A * y_start + B);
// 2. the block scans those (A, B) pairs in thread order, the JAX
//    combine (A1*A2, A2*B1 + B2): shuffles within a warp, then the
//    eight warp totals;
// 3. each thread applies its prefix to the tile's carry and runs its
//    chunk again from that carry, writing y in place;
// 4. the tile's last y is the next tile's carry.
// Inside a chunk the second pass is the plain loop's arithmetic (no FMA
// contraction), so results differ from it only by the rounding of the
// chunk carries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                      // samples per thread a tile
constexpr int kTile = kThreads * kChunk;        // samples per tile
constexpr int kPadded = kTile + kTile / 32;     // one pad word every 32

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

struct Pair {
    float a, b;  // y_end = a * y_start + b
};

// earlier segment p, then q
__device__ __forceinline__ Pair combine(Pair p, Pair q) {
    return Pair{__fmul_rn(p.a, q.a), __fadd_rn(__fmul_rn(q.a, p.b), q.b)};
}

__global__ void __launch_bounds__(kThreads)
deemph_kernel(const float* __restrict__ x, const float* __restrict__ y_prev,
              const uint8_t* __restrict__ mask, float* __restrict__ y,
              float* __restrict__ y_out, int len, float a, float oma) {
    __shared__ float s[kPadded];
    __shared__ Pair warp_total[kWarps];
    __shared__ float carry;
    const int r = blockIdx.x;
    const long long base = static_cast<long long>(r) * len;
    const float* xr = x + base;
    float* yr = y + base;
    if (!mask[r]) {  // passed through, carry kept
        for (int i = threadIdx.x; i < len; i += kThreads) yr[i] = xr[i];
        if (threadIdx.x == 0) y_out[r] = y_prev[r];
        return;
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry = y_prev[r];
    for (int t0 = 0; t0 < len; t0 += kTile) {
        const int n = len - t0 < kTile ? len - t0 : kTile;
        for (int i = threadIdx.x; i < n; i += kThreads) s[pad(i)] = xr[t0 + i];
        __syncthreads();

        // 1. the thread's chunk from a zero carry
        const int lo = threadIdx.x * kChunk;
        const int hi = lo + kChunk < n ? lo + kChunk : n;
        Pair p{1.0f, 0.0f};
        for (int i = lo; i < hi; ++i) {
            p.a = __fmul_rn(p.a, a);
            p.b = __fadd_rn(__fmul_rn(a, p.b), __fmul_rn(oma, s[pad(i)]));
        }
        // 2. inclusive scan over the warp, then over the warp totals
#pragma unroll
        for (int k = 1; k < 32; k *= 2) {
            const Pair u{__shfl_up_sync(0xffffffffu, p.a, k),
                         __shfl_up_sync(0xffffffffu, p.b, k)};
            if (lane >= k) p = combine(u, p);
        }
        if (lane == 31) warp_total[warp] = p;
        __syncthreads();
        Pair before{1.0f, 0.0f};  // every earlier thread of the tile
        for (int w = 0; w < warp; ++w) before = combine(before, warp_total[w]);
        Pair lanes_before{__shfl_up_sync(0xffffffffu, p.a, 1),
                          __shfl_up_sync(0xffffffffu, p.b, 1)};
        if (lane > 0) before = combine(before, lanes_before);
        // 3. the chunk again, from its carry
        float v = lane == 0 && warp == 0 ? carry
                                         : __fadd_rn(__fmul_rn(before.a, carry), before.b);
        for (int i = lo; i < hi; ++i) {
            v = __fadd_rn(__fmul_rn(a, v), __fmul_rn(oma, s[pad(i)]));
            s[pad(i)] = v;
        }
        __syncthreads();
        // 4. store, and carry the tile's last output
        for (int i = threadIdx.x; i < n; i += kThreads) yr[t0 + i] = s[pad(i)];
        const float last = s[pad(n - 1)];
        __syncthreads();  // every thread has read s and carry
        if (threadIdx.x == 0) carry = last;
    }
    __syncthreads();
    if (threadIdx.x == 0) y_out[r] = len > 0 ? carry : y_prev[r];
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: [rows, len] float32; y_prev, y_out: [rows] float32; mask: [rows]
// bool (one byte each); a and oma = 1 - a as float32.
extern "C" int deemph_launch(const float* x, const float* y_prev, const uint8_t* mask,
                             float* y, float* y_out, int rows, int len, float a,
                             float oma, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rows == 0) return 0;
    deemph_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y_prev, mask, y, y_out, len, a, oma);
    return static_cast<int>(cudaGetLastError());
}
