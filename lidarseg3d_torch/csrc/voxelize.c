/* Hard voxelization in key order, the host pipeline's voxelizer
 * (lidarseg3d_torch/core/native_voxelize.py; the port's counterpart of the
 * JAX package's native/voxelize.c).
 *
 * Byte-identical to core/voxelize.py points_to_voxel(sort_by_key=True) on
 * float32 points: each point's cell is floorf((p - lo) / size) per axis in
 * float32, points outside the grid are dropped, voxels come out in
 * ascending linear (z, y, x) key order with their points in scan order (a
 * stable LSD radix sort of 32-bit keys), the first max_points points of a
 * voxel are stored, and past max_voxels the smallest keys are kept.
 *
 * Built by ops/cuda_build.py with the system C compiler; plain C, no
 * dependencies.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* stable LSD radix sort of (key, index) pairs, four 8-bit passes: the
 * result ends in the original buffers */
static void radix_sort(uint32_t *key, int32_t *idx, int64_t n,
                       uint32_t *key_tmp, int32_t *idx_tmp) {
    int64_t count[257];
    for (int shift = 0; shift < 32; shift += 8) {
        memset(count, 0, sizeof(count));
        for (int64_t i = 0; i < n; ++i)
            count[((key[i] >> shift) & 0xffu) + 1]++;
        for (int b = 0; b < 256; ++b)
            count[b + 1] += count[b];
        for (int64_t i = 0; i < n; ++i) {
            int64_t at = count[(key[i] >> shift) & 0xffu]++;
            key_tmp[at] = key[i];
            idx_tmp[at] = idx[i];
        }
        uint32_t *k = key; key = key_tmp; key_tmp = k;
        int32_t *j = idx; idx = idx_tmp; idx_tmp = j;
    }
}

/* points [n, d] float32; voxel_size, coors_range (xyz, then xyz max)
 * float32; grid [3] (x, y, z) with x * y * z < 2^32. Writes voxels
 * [max_voxels, max_points, d] (zeroed by the caller), coors [max_voxels,
 * 3] (z, y, x) and num_points [max_voxels]; returns the voxel count, or -1
 * when memory runs out. */
int64_t voxelize_sorted(const float *points, int64_t n, int64_t d,
                        const float *voxel_size, const float *coors_range,
                        int64_t max_points, int64_t max_voxels,
                        const int64_t *grid, float *voxels, int32_t *coors,
                        int32_t *num_points) {
    if (n <= 0 || max_voxels <= 0) return 0;
    uint32_t *key = malloc(sizeof(uint32_t) * n);
    int32_t *idx = malloc(sizeof(int32_t) * n);
    uint32_t *key_tmp = malloc(sizeof(uint32_t) * n);
    int32_t *idx_tmp = malloc(sizeof(int32_t) * n);
    int64_t nv = -1;
    if (!key || !idx || !key_tmp || !idx_tmp) goto done;

    const int64_t gx = grid[0], gy = grid[1];
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float *p = points + i * d;
        int64_t c[3];
        int inside = 1;
        for (int a = 0; a < 3; ++a) {
            c[a] = (int64_t)floorf((p[a] - coors_range[a]) / voxel_size[a]);
            if (c[a] < 0 || c[a] >= grid[a]) inside = 0;
        }
        if (!inside) continue;
        key[m] = (uint32_t)((c[2] * gy + c[1]) * gx + c[0]);
        idx[m] = (int32_t)i;
        ++m;
    }
    radix_sort(key, idx, m, key_tmp, idx_tmp);

    const uint32_t plane = (uint32_t)(gy * gx);
    int64_t rank = 0;
    nv = 0;
    for (int64_t i = 0; i < m; ++i) {
        if (i == 0 || key[i] != key[i - 1]) {
            if (nv == max_voxels) break;  /* the smallest keys stay */
            const uint32_t k = key[i];
            coors[nv * 3 + 0] = (int32_t)(k / plane);
            coors[nv * 3 + 1] = (int32_t)((k % plane) / (uint32_t)gx);
            coors[nv * 3 + 2] = (int32_t)(k % (uint32_t)gx);
            num_points[nv] = 0;
            ++nv;
            rank = 0;
        }
        if (rank < max_points) {
            memcpy(voxels + ((nv - 1) * max_points + rank) * d,
                   points + (int64_t)idx[i] * d, sizeof(float) * d);
            num_points[nv - 1] = (int32_t)(rank + 1);
        }
        ++rank;
    }
done:
    free(key); free(idx); free(key_tmp); free(idx_tmp);
    return nv;
}
