// K3: all auto and cross P(k) bin sums of T rfft meshes in one pass over the modes.
//
// Replaces the per-pair loop of abacusutils_tpu/models/pipeline.py:
// hod_pk_fused_multi and pk_grouped_multi (one _segsum_matmul per tracer
// pair, each fed by a materialised Re(d_i conj(d_j)) mesh), whose all-pairs
// form is ops/power.py:_segsum_matmul_pairs (pairs stacked as extra LHS rows
// of one bin one-hot on the TPU's MXU). For every mode m of the
// (n1d, n1d, n1d/2+1) complex64 meshes d_0 .. d_{T-1} this kernel forms
//
//   d_t' = d_t[m] * scale / (W[ix] W[iy] W[kz])           (t < T)
//   dup(kz) * Re(d_i' conj(d_j'))                          (i <= j, i-major)
//
// and adds it to bin seg[m] of pair (i, j) (seg == nbins marks a mode
// outside every bin). dup is the Hermitian factor of K2 (csrc/mode_bin.cu):
// 1 on the kz=0 plane and on the kz=n1d/2 plane of an even mesh, 2 elsewhere.
//
// What bounds it on the H100: the shared-memory atomics. Each mode reads
// 8T + 4 bytes once (its T values and its bin) and the T(T+1)/2 pair
// products are formed in registers; the adds go to a private f32 histogram
// of npairs x nbins per block in shared memory (3 KB at 6 pairs x 128 bins),
// and neighbouring modes mostly share a bin, so those atomics serialise
// on-chip. Each block flushes its histogram once with native f64 global
// atomics. T is a template parameter (1..8), so the field and pair loops
// unroll into registers.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 8;

struct Fields {
    const float2* p[kMaxFields];
};

template <int T>
__global__ void mode_bin_pairs_kernel(Fields f, const int* __restrict__ seg,
                                      const float* __restrict__ W, float scale, int n1d,
                                      long long nmodes, int nbins, double* __restrict__ out) {
    constexpr int NP = T * (T + 1) / 2;
    extern __shared__ float hist[];  // [NP][nbins]
    for (int i = threadIdx.x; i < NP * nbins; i += blockDim.x) hist[i] = 0.f;
    __syncthreads();

    const int kzlen = n1d / 2 + 1;
    const bool even = (n1d % 2) == 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < nmodes;
         m += stride) {
        const int s = seg[m];
        if (s < 0 || s >= nbins) continue;
        const int kz = (int)(m % kzlen);
        float wd = 1.f;
        if (W != nullptr) {
            const long long r = m / kzlen;
            wd = W[(int)(r / n1d)] * W[(int)(r % n1d)] * W[kz];
        }
        float re[T], im[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
            const float2 v = f.p[t][m];
            re[t] = v.x * scale;
            im[t] = v.y * scale;
            if (W != nullptr) {
                re[t] /= wd;
                im[t] /= wd;
            }
        }
        const float dup = (kz == 0 || (even && kz == kzlen - 1)) ? 1.f : 2.f;
        int p = 0;
#pragma unroll
        for (int i = 0; i < T; ++i) {
#pragma unroll
            for (int j = i; j < T; ++j, ++p) {
                atomicAdd(hist + p * nbins + s, dup * (re[i] * re[j] + im[i] * im[j]));
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < NP * nbins; i += blockDim.x) {
        const float v = hist[i];
        if (v != 0.f) atomicAdd(out + i, (double)v);
    }
}

template <int T>
cudaError_t launch(const Fields& f, const int* seg, const float* W, float scale, int n1d,
                   int nbins, double* out, cudaStream_t stream) {
    const long long nmodes = (long long)n1d * n1d * (n1d / 2 + 1);
    const int threads = 256;
    long long blocks = (nmodes + threads - 1) / threads;
    int dev = 0, nsm = 0;
    cudaGetDevice(&dev);
    cudaError_t e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (blocks > 8LL * nsm) blocks = 8LL * nsm;  // a grid-stride loop covers the rest
    const size_t smem = sizeof(float) * (size_t)(T * (T + 1) / 2) * nbins;
    e = cudaFuncSetAttribute(mode_bin_pairs_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    mode_bin_pairs_kernel<T><<<(int)blocks, threads, smem, stream>>>(f, seg, W, scale, n1d,
                                                                      nmodes, nbins, out);
    return cudaGetLastError();
}

}  // namespace

// ---- host entry ----

extern "C" int mode_bin_pairs(const void* const* fields, int nfields, const int* seg,
                              const float* W, float scale, int n1d, int nbins, double* out,
                              void* stream) {
    if (nfields < 1 || nfields > kMaxFields) return (int)cudaErrorInvalidValue;
    Fields f = {};
    for (int t = 0; t < nfields; ++t) f.p[t] = (const float2*)fields[t];
    const cudaStream_t s = (cudaStream_t)stream;
    switch (nfields) {
        case 1: return (int)launch<1>(f, seg, W, scale, n1d, nbins, out, s);
        case 2: return (int)launch<2>(f, seg, W, scale, n1d, nbins, out, s);
        case 3: return (int)launch<3>(f, seg, W, scale, n1d, nbins, out, s);
        case 4: return (int)launch<4>(f, seg, W, scale, n1d, nbins, out, s);
        case 5: return (int)launch<5>(f, seg, W, scale, n1d, nbins, out, s);
        case 6: return (int)launch<6>(f, seg, W, scale, n1d, nbins, out, s);
        case 7: return (int)launch<7>(f, seg, W, scale, n1d, nbins, out, s);
        default: return (int)launch<8>(f, seg, W, scale, n1d, nbins, out, s);
    }
}
