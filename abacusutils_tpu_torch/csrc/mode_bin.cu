// K2: binned power of an rfft mesh, P(k) sums in one pass over the modes.
//
// Replaces abacusutils_tpu/ops/power.py:_segsum_matmul (the one-hot bin
// contraction on the TPU's MXU, fed by |delta_k / W|^2 materialised in
// device memory). For every mode m of the (n1d, n1d, n1d/2+1) complex64 mesh
// this kernel forms
//
//   dup(kz) * |delta_k[m] * scale / (W[ix] W[iy] W[kz])|^2
//
// and adds it to bin seg[m] (seg == nbins marks a mode outside every bin).
// dup is 1 on the kz=0 plane and on the kz=n1d/2 plane of an even mesh, 2
// elsewhere (the Hermitian convention of power.py:_mode_geometry).
//
// What bounds it on the H100: device memory. It reads 12 bytes a mode
// (8 for the complex value, 4 for its bin) once; everything else is
// registers. The design fuses scale, W-compensation, |.|^2 and the dup
// factor into that single read, keeps a private f32 histogram per block in
// shared memory (neighbouring modes share a bin, so the shared atomics
// contend, but only on-chip), and flushes each block's histogram with
// native f64 global atomics.

#include <cuda_runtime.h>

namespace {

__global__ void mode_bin_power_kernel(const float2* __restrict__ dk, const int* __restrict__ seg,
                                      const float* __restrict__ W, float scale, int n1d,
                                      long long nmodes, int nbins, double* __restrict__ out) {
    extern __shared__ float hist[];  // [nbins]
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0.f;
    __syncthreads();

    const int kzlen = n1d / 2 + 1;
    const bool even = (n1d % 2) == 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < nmodes;
         m += stride) {
        const int s = seg[m];
        if (s < 0 || s >= nbins) continue;
        const int kz = (int)(m % kzlen);
        const long long r = m / kzlen;
        const int iy = (int)(r % n1d);
        const int ix = (int)(r / n1d);
        const float2 v = dk[m];
        float re = v.x * scale;
        float im = v.y * scale;
        if (W != nullptr) {
            const float wd = W[ix] * W[iy] * W[kz];
            re /= wd;
            im /= wd;
        }
        const float dup = (kz == 0 || (even && kz == kzlen - 1)) ? 1.f : 2.f;
        atomicAdd(hist + s, dup * (re * re + im * im));
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
        const float v = hist[i];
        if (v != 0.f) atomicAdd(out + i, (double)v);
    }
}

}  // namespace

// ---- host entry ----

extern "C" int mode_bin_power(const void* delta_k, const int* seg, const float* W, float scale,
                              int n1d, int nbins, double* out, void* stream) {
    const long long nmodes = (long long)n1d * n1d * (n1d / 2 + 1);
    const int threads = 256;
    long long blocks = (nmodes + threads - 1) / threads;
    int dev = 0, nsm = 0;
    cudaGetDevice(&dev);
    cudaError_t e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (blocks > 8LL * nsm) blocks = 8LL * nsm;  // a grid-stride loop covers the rest
    const size_t smem = sizeof(float) * (size_t)nbins;
    e = cudaFuncSetAttribute(mode_bin_power_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    mode_bin_power_kernel<<<(int)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const float2*)delta_k, seg, W, scale, n1d, nmodes, nbins, out);
    return (int)cudaGetLastError();
}
