// K1: TSC deposit of cell-sorted weighted points into a periodic nmesh^3 grid.
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

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floor_mod(int i, int n) { return ((i % n) + n) % n; }

// One axis of the TSC cloud, the f32 arithmetic of ops/grid.py:_axis_cloud
// (single periodic wrap, then round half up). Returns the centre index.
__device__ __forceinline__ int axis_cloud(float p, float box, float offset, float inv_h,
                                          float w[3]) {
    if (p >= box) p = __fsub_rn(p, box);
    if (p < 0.f) p = __fadd_rn(p, box);
    const float g = __fmul_rn(__fadd_rn(p, offset), inv_h);
    const float i0 = floorf(__fadd_rn(g, 0.5f));
    const float d = __fsub_rn(i0, g);
    const float a = __fadd_rn(0.5f, d);
    const float b = __fsub_rn(0.5f, d);
    w[0] = __fmul_rn(0.5f, __fmul_rn(a, a));
    w[1] = __fsub_rn(0.75f, __fmul_rn(d, d));
    w[2] = __fmul_rn(0.5f, __fmul_rn(b, b));
    return (int)i0;
}

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
        axis_cloud(x[p], box, offset, inv_h, wx);
        const int iy = axis_cloud(y[p], box, offset, inv_h, wy);
        const int iz = axis_cloud(z[p], box, offset, inv_h, wz);
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

}  // namespace

// ---- host entry ----

extern "C" int tsc_deposit_cells(float* grid, const float* x, const float* y, const float* z,
                                 const float* w, const int* starts, int ncell, int nmesh,
                                 int yb, float box, float offset, int* err, void* stream) {
    const size_t smem = sizeof(float) * 3 * (size_t)(yb + 2) * nmesh;
    cudaError_t e = cudaFuncSetAttribute(tsc_deposit_cells_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    tsc_deposit_cells_kernel<<<ncell, 256, smem, (cudaStream_t)stream>>>(
        grid, x, y, z, w, starts, nmesh, yb, box, offset, err);
    return (int)cudaGetLastError();
}
