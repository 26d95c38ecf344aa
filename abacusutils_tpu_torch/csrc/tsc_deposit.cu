// K1: TSC or CIC deposit of cell-sorted weighted points into a periodic nmesh^3 grid.
//
// Replaces the TPU deposit abacusutils_tpu/ops/grid_pallas.py:_deposit_kernel
// (and its XLA twin ops/grid.py:paint_grouped_yb_multi + fold_ypad). On the
// TPU a cell's deposit was a one-hot matrix product on the MXU, fed from a
// padded (ncell, K) layout. Here the points stay in the cell-sorted order of
// the staging sort, and each thread block owns one (x-cell, y-block) cell:
//
//   1. zero a shared-memory tile holding the cell's whole TSC footprint,
//      3 x-planes x (yb + 2) y-rows x nmesh z-columns (104,448 B at
//      nmesh=256, yb=32);
//   2. threads stride over the cell's points [starts[c], starts[c+1]) and
//      add the 27 stencil weights with shared-memory atomics;
//   3. flush the tile's non-zero entries with global atomics, wrapping x and
//      y periodically, so no ghost-row fold pass is needed.
//
// What bounds it on the H100: the stencil adds. 27 shared atomics per kept
// point are the inner loop; points of one halo land in the same few z
// columns, so atomics on one address serialise. The design keeps all of
// that traffic in shared memory (one device-memory read of x, y, z, w per
// point, one global atomic per touched grid cell per block) and skips
// points of zero weight, which are most of the catalog in the HOD step.
//
// The cell index must agree bit for bit with the staging key
// (ops/grid.py:cell_key_2d): every step of the index arithmetic uses the
// _rn intrinsics so nvcc cannot contract it into an FMA, and a point whose
// y lands outside the block is counted in *err instead of being written.
//
// KIND (a template parameter) is 0 for TSC and 1 for CIC. CIC uses the same
// 3-point stencil and tile (weights max(d,0), 1-|d|, max(-d,0), as
// abacusutils_tpu/ops/grid.py:_cloud_weights_cic) and the JAX package's CIC
// convention: the position is not wrapped, so the cell is floor((p + offset)
// * inv_h + 0.5) of the raw coordinate, taken modulo nmesh.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floor_mod(int i, int n) { return ((i % n) + n) % n; }

// One axis of the cloud, the f32 arithmetic of ops/grid.py:_axis_cloud (TSC:
// single periodic wrap, then round half up; CIC: no wrap). Returns the
// centre index, not yet taken modulo nmesh.
template <int KIND>
__device__ __forceinline__ int axis_cloud(float p, float box, float offset, float inv_h,
                                          float w[3]) {
    if (KIND == 0) {
        if (p >= box) p = __fsub_rn(p, box);
        if (p < 0.f) p = __fadd_rn(p, box);
    }
    const float g = __fmul_rn(__fadd_rn(p, offset), inv_h);
    const float i0 = floorf(__fadd_rn(g, 0.5f));
    const float d = __fsub_rn(i0, g);
    if (KIND == 0) {
        const float a = __fadd_rn(0.5f, d);
        const float b = __fsub_rn(0.5f, d);
        w[0] = __fmul_rn(0.5f, __fmul_rn(a, a));
        w[1] = __fsub_rn(0.75f, __fmul_rn(d, d));
        w[2] = __fmul_rn(0.5f, __fmul_rn(b, b));
    } else {
        w[0] = fmaxf(d, 0.f);
        w[1] = __fsub_rn(1.f, fabsf(d));
        w[2] = fmaxf(-d, 0.f);
    }
    return (int)i0;
}

template <int KIND>
__global__ void tsc_deposit_cells_kernel(float* __restrict__ grid,
                                         const float* __restrict__ x,
                                         const float* __restrict__ y,
                                         const float* __restrict__ z,
                                         const float* __restrict__ w,
                                         const int* __restrict__ starts, int nmesh,
                                         int yb, float box, float offset,
                                         int* __restrict__ err) {
    extern __shared__ float tile[];  // [3][yb + 2][nmesh]
    const int c = blockIdx.x;
    const int begin = starts[c];
    const int end = starts[c + 1];
    if (begin == end) return;  // uniform across the block

    const int nyb = nmesh / yb;
    const int cx = c / nyb;
    const int y0 = (c % nyb) * yb;
    const int yw = yb + 2;
    const int tile_n = 3 * yw * nmesh;
    for (int i = threadIdx.x; i < tile_n; i += blockDim.x) tile[i] = 0.f;
    __syncthreads();

    const float inv_h = __fdiv_rn((float)nmesh, box);
    for (int p = begin + threadIdx.x; p < end; p += blockDim.x) {
        const float wp = w[p];
        if (wp == 0.f) continue;
        float wx[3], wy[3], wz[3];
        axis_cloud<KIND>(x[p], box, offset, inv_h, wx);
        const int iy = axis_cloud<KIND>(y[p], box, offset, inv_h, wy);
        const int iz = axis_cloud<KIND>(z[p], box, offset, inv_h, wz);
        const int ly = floor_mod(iy, nmesh) - y0 + 1;  // tile row of the centre
        if (ly < 1 || ly > yb) {
            atomicAdd(err, 1);
            continue;
        }
        const int izm = floor_mod(iz, nmesh);
        const int zc[3] = {izm == 0 ? nmesh - 1 : izm - 1, izm,
                           izm == nmesh - 1 ? 0 : izm + 1};
        for (int a = 0; a < 3; ++a) {
            for (int b = 0; b < 3; ++b) {
                const float wab = __fmul_rn(__fmul_rn(wx[a], wy[b]), wp);
                float* row = tile + (a * yw + ly + b - 1) * nmesh;
                for (int k = 0; k < 3; ++k) atomicAdd(row + zc[k], __fmul_rn(wab, wz[k]));
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
        const float v = tile[i];
        if (v == 0.f) continue;
        const int iz = i % nmesh;
        const int j = (i / nmesh) % yw;
        const int a = i / (nmesh * yw);
        const int gx = floor_mod(cx + a - 1, nmesh);
        const int gy = floor_mod(y0 + j - 1, nmesh);
        atomicAdd(grid + ((size_t)gx * nmesh + gy) * nmesh + iz, v);
    }
}

template <int KIND>
cudaError_t launch(float* grid, const float* x, const float* y, const float* z, const float* w,
                   const int* starts, int ncell, int nmesh, int yb, float box, float offset,
                   int* err, cudaStream_t stream) {
    const size_t smem = sizeof(float) * 3 * (size_t)(yb + 2) * nmesh;
    cudaError_t e = cudaFuncSetAttribute(tsc_deposit_cells_kernel<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    tsc_deposit_cells_kernel<KIND><<<ncell, 256, smem, stream>>>(grid, x, y, z, w, starts, nmesh,
                                                                 yb, box, offset, err);
    return cudaGetLastError();
}

}  // namespace

// ---- host entry ----

extern "C" int tsc_deposit_cells(float* grid, const float* x, const float* y, const float* z,
                                 const float* w, const int* starts, int ncell, int nmesh,
                                 int yb, float box, float offset, int kind, int* err,
                                 void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (kind) {
        case 0: return (int)launch<0>(grid, x, y, z, w, starts, ncell, nmesh, yb, box, offset, err, s);
        case 1: return (int)launch<1>(grid, x, y, z, w, starts, ncell, nmesh, yb, box, offset, err, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
