// K-AGC: look-ahead AGC + float -> int16, one block per channel.
//
// Replaces the gain lax.scan of agc_process and its sliding window max
// (phantomsdr_tpu/ops/agc.py, _sliding_max_abs + the scan), and
// float_to_int16 (phantomsdr_tpu/ops/channelizer.py).  Per channel:
//
//   y = [tail (W-1), x (L)]
//   peak[t]    = max |y[t .. t+W-1]|                (exact)
//   desired[t] = level / (peak[t] + 1e-10)
//   gain       : attack when desired < gain, else release, frozen until
//                W samples have been seen (the `seen` clamp)
//   out[t]     = seen+t+1 >= W ? y[t] * gain[t] : 0
//   int16      = clamp(floor(out*16384 + 32768.5) - 32768)   (half up)
//
// written straight into the [B, C, half] audio slice of the packed
// output buffer (t = b*half + s), with the new tail, gain and seen.
//
// The window max is exact by doubling: after k passes buffer m holds
// max|y[i .. i+2^k-1]|, and peak[t] = max(m[t], m[t + W - 2^k]) with
// 2^k <= W < 2^(k+1).  Both buffers (2 * (W-1+L) floats, 71 KB at
// W = 2400, L = 6480) live in shared memory, or in a device scratch
// buffer the wrapper passes when they exceed it.
//
// Bound: the gain recursion, a dependent chain of L steps per channel
// (a subtract, a multiply, a subtract and a select per step); its
// inputs (desired) are precomputed in parallel so the chain only reads
// shared memory.  All channels run at once, one block each.
// Round-to-nearest intrinsics keep the float32 operations separate,
// like the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float sample(const float* tail, const float* x,
                                        int w1, int i) {
    return i < w1 ? tail[i] : x[i - w1];
}

__global__ void __launch_bounds__(kThreads)
agc_kernel(const float* __restrict__ x, const float* __restrict__ tail,
           const float* __restrict__ gain0, const int* __restrict__ seen0,
           int channels, int len, int window, float attack, float release,
           float level, int half, int16_t* __restrict__ out,
           float* __restrict__ tail_out, float* __restrict__ gain_out,
           int* __restrict__ seen_out, float* __restrict__ scratch) {
    extern __shared__ float smem[];
    const int c = blockIdx.x;
    const int w1 = window - 1;
    const int m = w1 + len;
    float* a = scratch != nullptr ? scratch + 2LL * m * c : smem;
    float* b = a + m;
    const float* xc = x + static_cast<long long>(c) * len;
    const float* tc = tail + static_cast<long long>(c) * w1;

    for (int i = threadIdx.x; i < m; i += kThreads) a[i] = fabsf(sample(tc, xc, w1, i));
    for (int i = threadIdx.x; i < w1; i += kThreads)
        tail_out[static_cast<long long>(c) * w1 + i] = sample(tc, xc, w1, len + i);
    __syncthreads();

    // doubling window max
    float* cur = a;
    float* nxt = b;
    int span = 1;
    int valid = m;
    while (2 * span <= window) {
        valid -= span;
        for (int i = threadIdx.x; i < valid; i += kThreads)
            nxt[i] = fmaxf(cur[i], cur[i + span]);
        __syncthreads();
        float* t = cur;
        cur = nxt;
        nxt = t;
        span *= 2;
    }
    for (int t = threadIdx.x; t < len; t += kThreads) {
        const float pk = fmaxf(cur[t], cur[t + window - span]);
        nxt[t] = __fdiv_rn(level, __fadd_rn(pk, 1e-10f));
    }
    __syncthreads();

    // the gain recursion: nxt[t] holds desired[t] in, gain[t] out
    const int seen = seen0[c];
    if (threadIdx.x == 0) {
        float g = gain0[c];
#pragma unroll 8
        for (int t = 0; t < len; ++t) {
            const float d = nxt[t];
            if (seen + t + 1 >= window) {
                const float att = __fsub_rn(g, __fmul_rn(attack, __fsub_rn(g, d)));
                const float rel = __fadd_rn(g, __fmul_rn(release, __fsub_rn(d, g)));
                g = d < g ? att : rel;
            }
            nxt[t] = g;
        }
        gain_out[c] = g;
        seen_out[c] = seen + len < window ? seen + len : window;
    }
    __syncthreads();

    for (int t = threadIdx.x; t < len; t += kThreads) {
        const float o = seen + t + 1 >= window
                            ? __fmul_rn(sample(tc, xc, w1, t), nxt[t]) : 0.0f;
        float v = __fsub_rn(floorf(__fadd_rn(__fmul_rn(o, 16384.0f), 32768.5f)),
                            32768.0f);
        v = fminf(fmaxf(v, -32768.0f), 32767.0f);
        const int hb = t / half;
        const int s = t - hb * half;
        out[(static_cast<long long>(hb) * channels + c) * half + s] =
            static_cast<int16_t>(v);
    }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [channels, len] float32; tail: [channels, window-1]; gain0: [C]
// float32; seen0: [C] int32; out: [len/half, channels, half] int16;
// tail_out/gain_out/seen_out like the inputs; scratch: null (shared
// memory) or 2 * (window-1+len) * channels floats.
extern "C" int agc_launch(const float* x, const float* tail, const float* gain0,
                          const int* seen0, int channels, int len, int window,
                          float attack, float release, float level, int half,
                          int16_t* out, float* tail_out, float* gain_out,
                          int* seen_out, float* scratch, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    const size_t smem = scratch != nullptr
                            ? 0 : 2 * sizeof(float) * static_cast<size_t>(window - 1 + len);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(agc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    agc_kernel<<<channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, tail, gain0, seen0, channels, len, window, attack, release, level, half,
        out, tail_out, gain_out, seen_out, scratch);
    return static_cast<int>(cudaGetLastError());
}
