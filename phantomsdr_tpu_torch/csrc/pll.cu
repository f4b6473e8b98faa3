// K-PLL: AM carrier-synchronous detection, one chain thread per channel.
//
// Replaces the per-sample lax.scan of am_sync_detect
// (phantomsdr_tpu/ops/channelizer.py, unrolled by ops/unroll.py): per
// sample, mix the carrier and the baseband down by the NCO
// exp(-i*phase), err = arg(carrier mixed), freq += alpha*err,
// phase = mod(phase + beta*err + freq, 2*pi) with jnp.mod's sign rule
// (fmodf, then + 2*pi if negative), output = Re(baseband mixed).
//
// Bound: the dependent chain sincos -> complex product -> atan2 ->
// loop update -> wrap, sample after sample; its ~16 MB of traffic at
// the bench shape is microseconds.  pll_chain_probe runs the same loop
// over a carrier held in registers (no loads, no stores), and its time
// is the floor this kernel is measured against.
//
// Design: the chain thread runs alone.  The compiler keeps a warp's
// lanes able to reconverge wherever later code needs them together
// (__syncwarp, barriers, waits on other threads), and then brackets
// every data-dependent branch inside sincosf/atan2f with convergence
// barriers (BSSY/BSYNC), which lengthen the chain (by 19% at the bench
// shape, measured with the probe run inside a warp that waited for it).
// So every other thread leaves before the chain starts, and the work is
// split in two kernels:
// - pll_chain_kernel, one block per channel (channels <= SMs gives every
//   chain an SM to itself): 128 threads copy the channel's carrier into
//   shared memory with coalesced loads, then all but thread 0 exit.
//   Thread 0 runs the chain, reading the carrier four samples at a time
//   and storing the phase the NCO used for each sample into out.  Rows
//   longer than kPiece samples run as several launches that carry
//   phase and freq.
// - pll_output_kernel, one thread per sample: out = bb.x*cos + bb.y*sin
//   from that phase (sincosf of the same phase gives the chain's own cos
//   and sin), in place.
// The wrap: with x = phase + freq in (-2pi, 4pi) (float32 2pi),
// x >= 2pi ? x - 2pi : (x < 0 ? x + 2pi : x) equals fmodf plus the sign
// fix bit for bit (x - 2pi is exact by Sterbenz's lemma; the strict
// ends matter: fmodf gives 0 at 4pi and -0 at -2pi).  Outside that range
// the chain calls fmodf, out of line so that the loop stays small.
// Arithmetic: libdevice's accurate sincosf/atan2f, and round-to-nearest
// intrinsics (no FMA contraction) in the plain version's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLoadThreads = 128;  // threads that stage the carrier
constexpr int kPiece = 16384;      // samples per chain launch (128 KB of carrier)
constexpr int kOutThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __noinline__ float wrap_fmod(float x, float two_pi) {
    const float r = fmodf(x, two_pi);
    return r < 0.0f ? __fadd_rn(r, two_pi) : r;
}

__device__ __forceinline__ float wrap_phase(float x, float two_pi, float four_pi) {
    if (x > -two_pi && x < four_pi)
        return x >= two_pi ? __fsub_rn(x, two_pi)
                           : (x < 0.0f ? __fadd_rn(x, two_pi) : x);
    return wrap_fmod(x, two_pi);
}

struct Loop {
    float alpha, beta, two_pi, four_pi;

    // One sample: advance phase and freq by carrier sample vc.
    __device__ __forceinline__ void step(float2 vc, float& phase, float& freq) const {
        float sn, cs;
        sincosf(phase, &sn, &cs);  // exp(-i*phase) = cs - i*sn
        const float re = __fadd_rn(__fmul_rn(vc.x, cs), __fmul_rn(vc.y, sn));
        const float im = __fsub_rn(__fmul_rn(vc.y, cs), __fmul_rn(vc.x, sn));
        const float err = atan2f(im, re);
        freq = __fadd_rn(freq, __fmul_rn(alpha, err));
        phase = __fadd_rn(phase, __fmul_rn(beta, err));
        phase = wrap_phase(__fadd_rn(phase, freq), two_pi, four_pi);
    }

    // Four samples (a = samples 0, 1; b = samples 2, 3); returns the
    // phase the NCO used for each.
    __device__ __forceinline__ float4 step4(float4 a, float4 b, float& phase,
                                            float& freq) const {
        float4 ph;
        ph.x = phase;
        step(make_float2(a.x, a.y), phase, freq);
        ph.y = phase;
        step(make_float2(a.z, a.w), phase, freq);
        ph.z = phase;
        step(make_float2(b.x, b.y), phase, freq);
        ph.w = phase;
        step(make_float2(b.z, b.w), phase, freq);
        return ph;
    }
};

__global__ void __launch_bounds__(kLoadThreads)
pll_chain_kernel(const float2* __restrict__ carrier, const float* phase0,
                 const float* freq0, float* __restrict__ out, float* phase_out,
                 float* freq_out, int len, int start, int n, Loop loop) {
    extern __shared__ __align__(16) float2 car[];  // samples start .. start+n
    const int c = blockIdx.x;
    const long long row = static_cast<long long>(c) * len + start;
    const float2* pc = carrier + row;
    for (int i = threadIdx.x; i < n; i += kLoadThreads) car[i] = pc[i];
    __syncthreads();
    if (threadIdx.x != 0) return;

    // the chain, alone
    float* po = out + row;
    float phase = phase0[c];
    float freq = freq0[c];
    const float4* c4 = reinterpret_cast<const float4*>(car);
    int t = 0;
    for (; t + 4 <= n; t += 4) {
        const float4 ph = loop.step4(c4[t / 2], c4[t / 2 + 1], phase, freq);
        po[t] = ph.x;
        po[t + 1] = ph.y;
        po[t + 2] = ph.z;
        po[t + 3] = ph.w;
    }
    for (; t < n; ++t) {
        po[t] = phase;
        loop.step(car[t], phase, freq);
    }
    phase_out[c] = phase;
    freq_out[c] = freq;
}

// out holds the NCO phase of each sample; replace it by the output.
__global__ void __launch_bounds__(kOutThreads)
pll_output_kernel(const float2* __restrict__ baseband, float* __restrict__ out,
                  long long total) {
    const long long stride = static_cast<long long>(gridDim.x) * kOutThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kOutThreads + threadIdx.x;
         i < total; i += stride) {
        float sn, cs;
        sincosf(out[i], &sn, &cs);
        const float2 v = baseband[i];
        out[i] = __fadd_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn));
    }
}

// The chain alone: the same four-sample groups over four carrier
// samples held in registers, no loads or stores inside the loop; one
// thread per channel, alone like pll_chain_kernel's.
__global__ void __launch_bounds__(32)
pll_chain_probe(const float2* __restrict__ carrier, const float* __restrict__ phase0,
                const float* __restrict__ freq0, float* __restrict__ phase_out,
                float* __restrict__ freq_out, int len, Loop loop) {
    if (threadIdx.x != 0) return;
    const int c = blockIdx.x;
    float phase = phase0[c];
    float freq = freq0[c];
    if (len > 0) {
        const float2* pc = carrier + static_cast<long long>(c) * len;
        const float2 v0 = pc[0], v1 = pc[1 % len], v2 = pc[2 % len], v3 = pc[3 % len];
        const float4 a = make_float4(v0.x, v0.y, v1.x, v1.y);
        const float4 b = make_float4(v2.x, v2.y, v3.x, v3.y);
        int t = 0;
        for (; t + 4 <= len; t += 4) loop.step4(a, b, phase, freq);
        for (; t < len; ++t) loop.step(v0, phase, freq);
    }
    phase_out[c] = phase;
    freq_out[c] = freq;
}

Loop make_loop(float alpha, float beta, float two_pi) {
    // 2 * two_pi is exact (a power-of-two scaling)
    return Loop{alpha, beta, two_pi, 2.0f * two_pi};
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// carrier, baseband: [channels, len] complex64; out: [channels, len]
// float32; phase0/freq0 -> phase_out/freq_out: [channels] float32.
extern "C" int pll_launch(const void* carrier, const void* baseband,
                          const float* phase0, const float* freq0, float* out,
                          float* phase_out, float* freq_out, int channels,
                          int len, float alpha, float beta, float two_pi,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Loop loop = make_loop(alpha, beta, two_pi);
    static bool opted_in[kMaxDevices] = {};  // the shared memory of a piece, once per device
    if (device >= kMaxDevices || !opted_in[device]) {
        err = cudaFuncSetAttribute(pll_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(sizeof(float2)) * kPiece);
        if (err != cudaSuccess) {
            cudaGetLastError();  // not left for the next launcher to report
            return static_cast<int>(err);
        }
        if (device < kMaxDevices) opted_in[device] = true;
    }
    int start = 0;
    do {  // at least once, so that len == 0 still carries phase and freq
        const int n = len - start < kPiece ? len - start : kPiece;
        pll_chain_kernel<<<channels, kLoadThreads, sizeof(float2) * n, st>>>(
            static_cast<const float2*>(carrier), start == 0 ? phase0 : phase_out,
            start == 0 ? freq0 : freq_out, out, phase_out, freq_out, len, start, n,
            loop);
        start += n;
    } while (start < len);
    const long long total = static_cast<long long>(channels) * len;
    if (total > 0) {
        const long long blocks = (total + kOutThreads - 1) / kOutThreads;
        pll_output_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kOutThreads,
                            0, st>>>(static_cast<const float2*>(baseband), out, total);
    }
    return static_cast<int>(cudaGetLastError());
}

// The chain floor of pll_launch's shapes: phase_out/freq_out only.
extern "C" int pll_chain_probe_launch(const void* carrier, const float* phase0,
                                      const float* freq0, float* phase_out,
                                      float* freq_out, int channels, int len,
                                      float alpha, float beta, float two_pi,
                                      int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    pll_chain_probe<<<channels, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(carrier), phase0, freq0, phase_out, freq_out, len,
        make_loop(alpha, beta, two_pi));
    return static_cast<int>(cudaGetLastError());
}
