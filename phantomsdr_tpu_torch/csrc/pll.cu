// K-PLL: AM carrier-synchronous detection, one thread per channel.
//
// Replaces the per-sample lax.scan of am_sync_detect
// (phantomsdr_tpu/ops/channelizer.py, unrolled by ops/unroll.py): per
// sample, mix the carrier and the baseband down by the NCO
// exp(-i*phase), err = arg(carrier mixed), freq += alpha*err,
// phase = mod(phase + beta*err + freq, 2*pi) with jnp.mod's sign rule
// (fmodf, then + 2*pi if negative), output = Re(baseband mixed).
//
// Bound: the dependent chain.  Each channel's 6,480 samples per step
// are strictly sequential (sincos -> atan2 -> phase update), so the
// kernel's time is the chain's latency, not its ~16 MB of traffic.
// The design runs every channel's chain at once (one thread each, 32
// to a block so the channels spread over SMs); each thread walks its
// own contiguous row, so its loads hit lines it pulled in on the
// previous samples.  Products and sums use round-to-nearest
// intrinsics (no FMA contraction), like the plain version's separate
// float32 operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
pll_kernel(const float2* __restrict__ carrier, const float2* __restrict__ baseband,
           const float* __restrict__ phase0, const float* __restrict__ freq0,
           float* __restrict__ out, float* __restrict__ phase_out,
           float* __restrict__ freq_out, int channels, int len, float alpha,
           float beta, float two_pi) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= channels) return;
    const long long row = static_cast<long long>(c) * len;
    const float2* pc = carrier + row;
    const float2* pb = baseband + row;
    float* po = out + row;
    float phase = phase0[c];
    float freq = freq0[c];
    for (int t = 0; t < len; ++t) {
        float sn, cs;
        sincosf(phase, &sn, &cs);  // exp(-i*phase) = cs - i*sn
        const float2 vc = pc[t];
        const float2 vb = pb[t];
        const float re = __fadd_rn(__fmul_rn(vc.x, cs), __fmul_rn(vc.y, sn));
        const float im = __fsub_rn(__fmul_rn(vc.y, cs), __fmul_rn(vc.x, sn));
        const float err = atan2f(im, re);
        freq = __fadd_rn(freq, __fmul_rn(alpha, err));
        phase = __fadd_rn(phase, __fmul_rn(beta, err));
        phase = fmodf(__fadd_rn(phase, freq), two_pi);
        if (phase < 0.0f) phase = __fadd_rn(phase, two_pi);
        po[t] = __fadd_rn(__fmul_rn(vb.x, cs), __fmul_rn(vb.y, sn));
    }
    phase_out[c] = phase;
    freq_out[c] = freq;
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
    const int blocks = (channels + kThreads - 1) / kThreads;
    pll_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(carrier), static_cast<const float2*>(baseband),
        phase0, freq0, out, phase_out, freq_out, channels, len, alpha, beta,
        two_pi);
    return static_cast<int>(cudaGetLastError());
}
