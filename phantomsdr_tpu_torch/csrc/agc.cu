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
// agc_float_launch runs the same kernel compiled with kFloat: it stores
// out[t] itself as float32 into a [C, L] buffer (the input of the WBFM
// and noise-reduction stages, which convert to int16 after them) and is
// otherwise the same.
//
// Bound: the gain recursion, a dependent chain of L steps per channel
// (a subtract, a multiply, a subtract and a select per step).
// agc_chain_probe runs the same loop over inputs held in registers (no
// loads, no stores), and its time is the floor this kernel is measured
// against.
//
// Design: one kernel, warp-specialised, so that the parallel work runs
// behind the chain instead of before and after it, and everything it
// keeps lives in shared memory at any window (38,400 samples at 192 kHz).
// - All 512 threads read y once: the max of |y| over each aligned block
//   of 128 samples (four a lane, then across the warp by shuffles), and
//   the new tail; a sparse table over the block maxes follows (level k
//   = max of 2^k blocks; 5 levels at W = 2400, 9 at 38,400).
// - Warp 0's lane 0 then runs the chain; its other lanes exit, so that
//   the chain has no lane to reconverge with (no convergence barriers;
//   see csrc/pll.cu).  From t0 = clamp(W-1-seen, 0, L) on (before it the
//   gain is frozen and the output 0) it has no branch: it reads desired
//   four at a time (float4, five groups in flight) from a ring of
//   kRing chunks of kChunk samples in shared memory and writes each gain
//   in its place.
// - Warps 1-15 fill the ring kRing - 1 chunks ahead of the chain.  For
//   the chunk's outputs t they read y again (from L2) and form, block
//   by block, the suffix max Q of |y| inside t's block and the prefix
//   max P inside the block of t+W-1 (at most 9 blocks each); then
//   peak[t] = max(Q[t], P[t+W-1], two table entries over the whole
//   blocks between), exact because max is associative (a window inside
//   one block, W <= 128, is read directly).  Behind the chain they write
//   the output of every chunk whose gains it has flagged as done, which
//   frees the chunk's slot for the next chunk ahead.
// The flags are shared-memory words (a releasing store, an acquiring
// load); the workers synchronise among themselves with named barrier 1.
// Shared memory: the table (levels x blocks of W-1+L samples: 22 KB at
// W = 38,400, L = 40,272), the ring and the Q and P of one chunk (25 KB).
// Round-to-nearest intrinsics keep the float32 operations separate, like
// the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWorkers = kThreads - 32;  // warps 1..15
constexpr int kSpan = 4;                 // samples per lane in a block of the window max
constexpr int kBlock = 32 * kSpan;       // samples per block
static_assert(kSpan == 4, "a lane stores its span as one float4");
constexpr int kUnroll = 6;               // blocks in flight per warp while reading y
constexpr int kChunk = 1024;             // samples per ring slot and per ready/done flag
constexpr int kRing = 4;                 // ring slots: the workers run kRing-1 chunks ahead
constexpr int kAhead = 6;                // float4 groups of desired the chain holds
constexpr int kChunkBlocks = kChunk / kBlock;
static_assert(kChunk % kBlock == 0, "a chunk is whole blocks");
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int blocks_of(int m) { return (m + kBlock - 1) / kBlock; }

// Levels of the sparse table: enough for the most whole blocks a window
// can cover, (W+kBlock-2)/kBlock - 1.
__host__ __device__ __forceinline__ int table_levels(int window) {
    int n = (window + kBlock - 2) / kBlock - 1;
    if (n < 1) n = 1;
    int k = 0;
    while (n >> k) ++k;
    return k;
}

// Floats of the table, padded to a multiple of four so that the ring
// after it stays 16-byte aligned.
__host__ __device__ __forceinline__ int table_floats(int window, int len) {
    return (table_levels(window) * blocks_of(window - 1 + len) + 3) & ~3;
}

// Floats of the ring with the chain's read-ahead past its end
// (4 * kAhead - 4), then Q of one chunk's blocks and P of the (at most
// kChunkBlocks + 1) blocks its window ends fall in.
constexpr int kRingFloats = kRing * kChunk + 4 * kAhead;
constexpr int kStageFloats = kChunk + (kChunkBlocks + 1) * kBlock;

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float sample(const float* tail, const float* x,
                                        int w1, int i) {
    return i < w1 ? tail[i] : x[i - w1];
}

// Where the chain starts: the first sample with seen+t+1 >= W.
__device__ __forceinline__ int warm_up_end(int seen, int window, int len) {
    return min(max(window - 1 - seen, 0), len);
}

__device__ __forceinline__ float agc_step(float g, float d, float attack,
                                          float release) {
    const float att = __fsub_rn(g, __fmul_rn(attack, __fsub_rn(g, d)));
    const float rel = __fadd_rn(g, __fmul_rn(release, __fsub_rn(d, g)));
    return d < g ? att : rel;
}

__device__ __forceinline__ float4 agc_step4(float& g, float4 d, float attack,
                                            float release) {
    float4 o;
    o.x = g = agc_step(g, d.x, attack, release);
    o.y = g = agc_step(g, d.y, attack, release);
    o.z = g = agc_step(g, d.z, attack, release);
    o.w = g = agc_step(g, d.w, attack, release);
    return o;
}

// A flag in shared memory: an acquiring load (what the flag's writer
// wrote before it is visible after it) and a releasing store.
__device__ __forceinline__ int load_flag(const int* f) {
    int v;
    asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(static_cast<unsigned>(__cvta_generic_to_shared(f)))
                 : "memory");
    return v;
}

__device__ __forceinline__ void publish_flag(int* f, int v) {
    asm volatile("st.release.cta.shared::cta.b32 [%0], %1;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(f))),
                 "r"(v)
                 : "memory");
}

__device__ __forceinline__ void workers_sync() {
    asm volatile("bar.sync 1, %0;" ::"r"(kWorkers) : "memory");
}

// The chain over samples [s, e), desired read from d and each gain
// written in its place.  Desired is read four samples at a time, kAhead
// - 1 groups ahead of use (a ring of registers, fully unrolled), so that
// shared-memory latency stays off the chain; reads past e stay inside
// the ring's padding.
__device__ __forceinline__ float chain(float* d, int s, int e, float g,
                                       float attack, float release) {
    int t = s;
    for (; t < e && (t & 3); ++t) d[t] = g = agc_step(g, d[t], attack, release);
    if (t + 4 <= e) {  // t is a multiple of four here
        float4 q[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead - 1; ++k) q[k] = load4(d + t + 4 * k);
        for (; t + 4 * kAhead <= e; t += 4 * kAhead) {
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                q[(k + kAhead - 1) % kAhead] = load4(d + t + 4 * (k + kAhead - 1));
                store4(d + t + 4 * k, agc_step4(g, q[k], attack, release));
            }
        }
#pragma unroll
        for (int k = 0; k < kAhead - 1; ++k) {
            if (t + 4 <= e) {
                store4(d + t, agc_step4(g, q[k], attack, release));
                t += 4;
            }
        }
    }
    for (; t < e; ++t) d[t] = g = agc_step(g, d[t], attack, release);
    return g;
}

// |y| over one block of kBlock samples, kSpan a lane: with kSuffix
// the max from each sample to the block's end (Q), else from the
// block's start to each sample (P), each lane's kSpan in turn and then
// across the warp by shuffles; stored at dst (kSpan floats a lane).
template <bool kSuffix>
__device__ __forceinline__ void block_scan(const float* tail, const float* x, int w1,
                                           int m, int block, int lane, float* dst) {
    const int base = block * kBlock + lane * kSpan;
    float p[kSpan];
#pragma unroll
    for (int s = 0; s < kSpan; ++s) p[s] = base + s < m ? fabsf(sample(tail, x, w1, base + s)) : 0.0f;
#pragma unroll
    for (int s = 1; s < kSpan; ++s) {
        if (kSuffix) p[kSpan - 1 - s] = fmaxf(p[kSpan - 1 - s], p[kSpan - s]);
        else p[s] = fmaxf(p[s], p[s - 1]);
    }
    float h = kSuffix ? p[0] : p[kSpan - 1];  // max over lanes lane..31 (Q), 0..lane (P)
#pragma unroll
    for (int s = 1; s < 32; s *= 2) {
        const float o = kSuffix ? __shfl_down_sync(0xffffffffu, h, s)
                                : __shfl_up_sync(0xffffffffu, h, s);
        if (kSuffix ? lane + s < 32 : lane >= s) h = fmaxf(h, o);
    }
    // |y| >= 0, so 0 is the max of no lanes
    float o = kSuffix ? __shfl_down_sync(0xffffffffu, h, 1) : __shfl_up_sync(0xffffffffu, h, 1);
    if (kSuffix ? lane == 31 : lane == 0) o = 0.0f;
    store4(dst + lane * kSpan, make_float4(fmaxf(p[0], o), fmaxf(p[1], o),
                                           fmaxf(p[2], o), fmaxf(p[3], o)));
}

// kFloat: the output is out[t] as float32 into out_f [C, L]; else int16
// into out [B, C, half].
template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
agc_kernel(const float* __restrict__ x, const float* __restrict__ tail,
           const float* __restrict__ gain0, const int* __restrict__ seen0,
           int channels, int len, int window, float attack, float release,
           float level, int half, int16_t* __restrict__ out,
           float* __restrict__ out_f, float* __restrict__ tail_out,
           float* __restrict__ gain_out, int* __restrict__ seen_out) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int ready;  // chunks whose desired is written
    __shared__ int done;   // chunks whose gains are written
    const int c = blockIdx.x;
    const int w1 = window - 1;
    const int m = w1 + len;
    const int nb = blocks_of(m);
    float* table = smem;
    float* ring = smem + table_floats(window, len);  // desired, then gains
    float* qs = ring + kRingFloats;                   // Q of one chunk's blocks
    float* ps = qs + kChunk;                          // P of its window ends' blocks
    const float* xc = x + static_cast<long long>(c) * len;
    const float* tc = tail + static_cast<long long>(c) * w1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) ready = done = 0;

    // the max of |y| per block of kBlock samples (kSpan a lane, then
    // across the warp), and the new tail
    for (int j0 = warp; j0 < nb; j0 += kUnroll * kWarps) {
        float v[kUnroll][kSpan];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int s = 0; s < kSpan; ++s) {
                const int i = (j0 + u * kWarps) * kBlock + lane * kSpan + s;
                v[u][s] = i < m ? sample(tc, xc, w1, i) : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u * kWarps;
            if (j >= nb) break;  // warp-uniform
            float h = 0.0f;
#pragma unroll
            for (int s = 0; s < kSpan; ++s) {
                const int i = j * kBlock + lane * kSpan + s;
                if (i >= len && i < m) tail_out[static_cast<long long>(c) * w1 + (i - len)] = v[u][s];
                h = fmaxf(h, fabsf(v[u][s]));
            }
#pragma unroll
            for (int s = 16; s > 0; s /= 2) h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, s));
            if (lane == 0) table[j] = h;
        }
    }
    __syncthreads();
    const int levels = table_levels(window);
    for (int k = 1; k < levels; ++k) {
        const float* lo = table + (k - 1) * nb;
        float* hi = table + k * nb;
        const int h = 1 << (k - 1);
        for (int j = threadIdx.x; j + 2 * h <= nb; j += kThreads) hi[j] = fmaxf(lo[j], lo[j + h]);
        __syncthreads();
    }

    const int seen = seen0[c];
    const int t0 = warm_up_end(seen, window, len);
    const int chunks = (len + kChunk - 1) / kChunk;
    if (warp == 0) {
        if (lane != 0) return;
        // the chain, alone in its warp
        float g = gain0[c];
        for (int k = t0 / kChunk; k < chunks && t0 < len; ++k) {
            while (load_flag(&ready) <= k) {
            }
            const int base = k * kChunk;
            g = chain(ring + (k % kRing) * kChunk, max(t0, base) - base,
                      min(base + kChunk, len) - base, g, attack, release);
            publish_flag(&done, k + 1);
        }
        gain_out[c] = g;
        seen_out[c] = seen + len < window ? seen + len : window;
        return;
    }

    // workers: desired kRing-1 chunks ahead of the chain, the output
    // behind it
    const int wt = threadIdx.x - 32;
    const int first = t0 < len ? t0 / kChunk : chunks;  // the chain's first chunk
    auto fill = [&](int k) {
        const int base = k * kChunk;
        const int s = max(t0, base);
        const int e = min(base + kChunk, len);
        const int q0 = base / kBlock;
        const int p0 = (s + w1) / kBlock;
        const int nq = (e - 1) / kBlock - q0 + 1;
        const int np = (e - 1 + w1) / kBlock - p0 + 1;
        for (int b = warp - 1; b < nq + np; b += kWarps - 1) {
            if (b < nq) block_scan<true>(tc, xc, w1, m, q0 + b, lane, qs + b * kBlock);
            else block_scan<false>(tc, xc, w1, m, p0 + b - nq, lane, ps + (b - nq) * kBlock);
        }
        workers_sync();
        float* d = ring + (k % kRing) * kChunk;  // sample t at d[t - base]
        for (int t = s + wt; t < e; t += kWorkers) {
            const int last = t + w1;
            const int b0 = t / kBlock;
            const int b1 = last / kBlock;
            float pk;
            if (b0 == b1) {  // a window inside one block (W <= kBlock)
                pk = 0.0f;
                for (int i = t; i <= last; ++i) pk = fmaxf(pk, fabsf(sample(tc, xc, w1, i)));
            } else {
                pk = fmaxf(qs[t - base], ps[last - p0 * kBlock]);
                const int n = b1 - b0 - 1;
                if (n > 0) {
                    const int lv = 31 - __clz(n);
                    const float* row = table + lv * nb;
                    pk = fmaxf(pk, fmaxf(row[b0 + 1], row[b1 - (1 << lv)]));
                }
            }
            d[t - base] = __fdiv_rn(level, __fadd_rn(pk, 1e-10f));
        }
        workers_sync();
        if (wt == 0) publish_flag(&ready, k + 1);
    };
    int next = first;  // the next chunk to fill
    for (; next < chunks && next < first + kRing - 1; ++next) fill(next);
    for (int k = 0; k < chunks; ++k) {
        const int base = k * kChunk;
        const int e = min(base + kChunk, len);
        if (k >= first) {
            if (wt == 0)
                while (load_flag(&done) <= k) __nanosleep(100);
            workers_sync();
        }
        const float* g = ring + (k % kRing) * kChunk;
        for (int t = base + wt; t < e; t += kWorkers) {
            const float o = t >= t0 ? __fmul_rn(sample(tc, xc, w1, t), g[t - base]) : 0.0f;
            if (kFloat) {
                out_f[static_cast<long long>(c) * len + t] = o;
                continue;
            }
            float v = __fsub_rn(floorf(__fadd_rn(__fmul_rn(o, 16384.0f), 32768.5f)), 32768.0f);
            v = fminf(fmaxf(v, -32768.0f), 32767.0f);
            const int hb = t / half;
            const int s = t - hb * half;
            out[(static_cast<long long>(hb) * channels + c) * half + s] = static_cast<int16_t>(v);
        }
        // chunk k's slot is read; the slot of chunk k-1 (all workers are
        // past its output) takes chunk k + kRing - 1
        if (k >= first && next < chunks) fill(next++);
    }
}

// The chain alone: the same four-step groups over |x[0..3]| held in
// registers, no loads or stores inside it; one thread per channel,
// alone in its warp like agc_kernel's.
__global__ void __launch_bounds__(32)
agc_chain_probe(const float* __restrict__ x, const float* __restrict__ gain0,
                float* __restrict__ gain_out, int len, float attack, float release) {
    if (threadIdx.x != 0) return;
    const int c = blockIdx.x;
    float g = gain0[c];
    if (len > 0) {
        const float* xc = x + static_cast<long long>(c) * len;
        const float4 d = make_float4(fabsf(xc[0]), fabsf(xc[1 % len]),
                                     fabsf(xc[2 % len]), fabsf(xc[3 % len]));
        int t = 0;
        for (; t + 4 <= len; t += 4) agc_step4(g, d, attack, release);
        for (; t < len; ++t) g = agc_step(g, d.x, attack, release);
    }
    gain_out[c] = g;
}

// Opt in to all the shared memory a block may have, once per device
// and kernel (less the kernel's static flags).
template <bool kFloat>
cudaError_t opt_in_shared(int device) {
    static bool opted_in[kMaxDevices] = {};
    if (device < kMaxDevices && opted_in[device]) return cudaSuccess;
    int most = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, agc_kernel<kFloat>);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(agc_kernel<kFloat>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   most - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) {
        cudaGetLastError();  // not left for the next launcher to report
        return err;
    }
    if (device < kMaxDevices) opted_in[device] = true;
    return cudaSuccess;
}

// A table too large for shared memory (W-1+L past 736,768 samples at
// W = 38,400) is refused by the launch itself: it returns the error.
// ops/cuda/agc.py's max_stream mirrors this size, for the config to
// refuse such a step when it loads.
template <bool kFloat>
int launch(const float* x, const float* tail, const float* gain0, const int* seen0,
           int channels, int len, int window, float attack, float release, float level,
           int half, int16_t* out, float* out_f, float* tail_out, float* gain_out,
           int* seen_out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    err = opt_in_shared<kFloat>(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = sizeof(float) * (static_cast<size_t>(table_floats(window, len)) +
                                         kRingFloats + kStageFloats);
    agc_kernel<kFloat><<<channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, tail, gain0, seen0, channels, len, window, attack, release, level, half, out,
        out_f, tail_out, gain_out, seen_out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [channels, len] float32; tail: [channels, window-1]; gain0: [C]
// float32; seen0: [C] int32; out: [len/half, channels, half] int16;
// tail_out/gain_out/seen_out like the inputs.
extern "C" int agc_launch(const float* x, const float* tail, const float* gain0,
                          const int* seen0, int channels, int len, int window,
                          float attack, float release, float level, int half,
                          int16_t* out, float* tail_out, float* gain_out,
                          int* seen_out, int device, void* stream) {
    return launch<false>(x, tail, gain0, seen0, channels, len, window, attack, release,
                         level, half, out, nullptr, tail_out, gain_out, seen_out, device,
                         stream);
}

// agc_launch with a float32 output: out: [channels, len].
extern "C" int agc_float_launch(const float* x, const float* tail, const float* gain0,
                                const int* seen0, int channels, int len, int window,
                                float attack, float release, float level, float* out,
                                float* tail_out, float* gain_out, int* seen_out,
                                int device, void* stream) {
    return launch<true>(x, tail, gain0, seen0, channels, len, window, attack, release,
                        level, len, nullptr, out, tail_out, gain_out, seen_out, device,
                        stream);
}

// The chain floor of agc_launch's shapes: gain_out only.
extern "C" int agc_chain_probe_launch(const float* x, const float* gain0,
                                      float* gain_out, int channels, int len,
                                      float attack, float release, int device,
                                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    agc_chain_probe<<<channels, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, gain0, gain_out, len, attack, release);
    return static_cast<int>(cudaGetLastError());
}
