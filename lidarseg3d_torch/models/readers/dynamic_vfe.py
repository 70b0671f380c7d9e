"""Dynamic (in-model) voxel feature extractors of the SegPolarNet family
(PyTorch port of lidarseg3d_tpu/models/readers/dynamic_vfe.py):

- PolarNetDynamicVoxelFeatureExtractor: the cylindrical BEV grid; every
  point scatter-maxes straight into the dense BEV tensor;
- Cylinder3DDynamicVoxelFeatureExtractor: the sparse 3D cylindrical voxel
  set (``ops.dynamic_voxel.assign_points_to_voxels``: the merge kernel
  answers each point's voxel on the 480x360x32 grid's KeyTable) for the
  asymmetric sparse UNet, and the voted voxel labels in training.

Grid coordinates are clamped into range, so every valid point lands in a
boundary voxel rather than being dropped, as in the JAX package.
Submodule names follow the JAX package's Flax scopes.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import dynamic_voxel as dv
from ...ops import sparse as sp
from ..layers import MaskedBatchNorm, TorchLinear
from ..registry import READERS


def _cyl_grid_coords(points_xyz, point_cloud_range, grid_size):
    """points [B, N, 3] -> (cylindrical coords, clamped grid coords
    [B, N, 3] int32 in (r, phi, z) order, voxel size, lower bound)."""
    cyl = dv.cart2cylind(points_xyz)
    kw = dict(dtype=torch.float32, device=points_xyz.device)
    lo = torch.tensor(point_cloud_range[:3], **kw)
    hi = torch.tensor(point_cloud_range[3:], **kw)
    gs = torch.tensor(grid_size, **kw)
    vsize = (hi - lo) / gs
    c = torch.floor((cyl - lo) / vsize)
    c = torch.minimum(c.clamp(min=0), gs - 1).to(torch.int32)
    return cyl, c, vsize, lo


class _PPModel(nn.Module):
    """BN -> (Linear -> BN -> ReLU) x3 -> Linear."""

    def __init__(self, in_features, num_output_features):
        super().__init__()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_features)
        c = in_features
        for i, f in enumerate((64, 128, 256)):
            self.add_module(f"TorchLinear_{i}", TorchLinear(c, f))
            self.add_module(f"MaskedBatchNorm_{i + 1}", MaskedBatchNorm(f))
            c = f
        self.TorchLinear_3 = TorchLinear(c, num_output_features)

    def forward(self, x, mask):
        x = self.MaskedBatchNorm_0(x, mask=mask)
        for i in range(3):
            x = getattr(self, f"TorchLinear_{i}")(x)
            x = F.relu(getattr(self, f"MaskedBatchNorm_{i + 1}")(x, mask=mask))
        return self.TorchLinear_3(x)


def _prepare_input_features(cyl, cart_xy, extra, vcoords, vsize, lo, tgt,
                            n_cells, valid):
    """[cyl(3), cart_xy(2), extra] + the first five minus their cell mean
    + the offsets from the voxel centre."""
    B, N = cyl.shape[:2]
    first5 = torch.cat([cyl, cart_xy], dim=-1)  # [B, N, 5]
    vf = valid.reshape(-1, 1).to(cyl.dtype)
    s = dv.scatter_sum(n_cells + 1, tgt, first5.reshape(B * N, 5) * vf)
    cnt = dv.scatter_sum(n_cells + 1, tgt, vf)
    mean5 = (s / cnt.clamp(min=1.0))[tgt].reshape(B, N, 5)
    centers = (vcoords.to(torch.float32) + 0.5) * vsize + lo
    return torch.cat([first5, extra, first5 - mean5, cyl - centers], dim=-1)


def _in_features(num_input_features):
    """Width of the prepared features: 5 + the points' extra channels + 5
    normalized + 3 centre offsets."""
    return 5 + (num_input_features - 3) + 5 + 3


@READERS.register_module
class PolarNetDynamicVoxelFeatureExtractor(nn.Module):
    def __init__(self, grid_size=(480, 360, 32), point_cloud_range=(),
                 average_points=False, num_input_features=5,
                 num_output_features=512, fea_compre=32,
                 voxel_label_enc=None):
        super().__init__()
        self.grid_size = tuple(int(g) for g in grid_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.average_points = average_points
        self.num_output_features = num_output_features
        self._PPModel_0 = _PPModel(_in_features(num_input_features),
                                   num_output_features)
        self.fea_compre = fea_compre
        if fea_compre:
            self.TorchLinear_0 = TorchLinear(num_output_features, fea_compre)

    def forward(self, points, point_valid):
        """points [B, N, D] (x, y, z, intensity, ...) -> dict(bev_features
        [B, R, P, C], point_vcoors [B, N, 3] (r, phi, z), grid_size)."""
        B, N, _ = points.shape
        R, P, Z = self.grid_size
        cyl, c, vsize, lo = _cyl_grid_coords(
            points[..., :3], self.point_cloud_range, self.grid_size)
        cell = c[..., 0].to(torch.int64) * P + c[..., 1]  # z collapsed
        offs = (torch.arange(B, device=points.device) * (R * P))[:, None]
        n_cells = B * R * P
        tgt = torch.where(point_valid, cell + offs, n_cells).reshape(-1)
        feats = _prepare_input_features(cyl, points[..., :2], points[..., 3:],
                                        c, vsize, lo, tgt, n_cells,
                                        point_valid)
        x = self._PPModel_0(feats, point_valid)
        C = self.num_output_features
        flat = x.reshape(B * N, C)
        if self.average_points:
            vf = point_valid.reshape(-1, 1).to(x.dtype)
            s = dv.scatter_sum(n_cells + 1, tgt, flat * vf)
            cnt = dv.scatter_sum(n_cells + 1, tgt, vf)
            bev = (s / cnt.clamp(min=1.0))[:-1]
        else:
            masked = torch.where(point_valid.reshape(-1, 1), flat, -torch.inf)
            bev = x.new_full((n_cells + 1, C), -torch.inf).scatter_reduce(
                0, tgt[:, None].expand(B * N, C), masked, "amax")[:-1]
            bev = torch.where(torch.isfinite(bev), bev, 0.0)
        if self.fea_compre:
            bev = F.relu(self.TorchLinear_0(bev))
        return {"bev_features": bev.reshape(B, R, P, -1),
                "point_vcoors": c, "grid_size": (R, P, Z)}


@READERS.register_module
class Cylinder3DDynamicVoxelFeatureExtractor(nn.Module):
    def __init__(self, grid_size=(480, 360, 32), point_cloud_range=(),
                 average_points=False, num_input_features=5,
                 num_output_features=256, fea_compre=16, max_voxels=120000,
                 voxel_label_enc="major", num_class=17):
        super().__init__()
        self.grid_size = tuple(int(g) for g in grid_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.average_points = average_points
        self.max_voxels = max_voxels
        self.voxel_label_enc = voxel_label_enc
        self.num_class = num_class
        self._PPModel_0 = _PPModel(_in_features(num_input_features),
                                   num_output_features)
        self.fea_compre = fea_compre
        if fea_compre:
            self.TorchLinear_0 = TorchLinear(num_output_features, fea_compre)

    def forward(self, points, point_valid, point_sem_labels=None):
        """-> dict(sparse_tensor over the cylindrical grid, point_vcoors
        [B, N, 3], point_voxel_rows [B, N] (-1: no voxel), grid_size, and
        in training with labels voxel_sem_labels [B, cap])."""
        B, N, _ = points.shape
        R, P, Z = self.grid_size
        cyl, c, vsize, lo = _cyl_grid_coords(
            points[..., :3], self.point_cloud_range, self.grid_size)
        # the structure's (z, y, x) axes are (r, phi, z)
        struct, p2v, found = dv.assign_points_to_voxels(
            c, point_valid, (R, P, Z), self.max_voxels)
        cap = self.max_voxels
        offs = (torch.arange(B, device=points.device) * cap)[:, None]
        n_cells = B * cap
        tgt = torch.where(found, p2v.to(torch.int64) + offs,
                          n_cells).reshape(-1)
        feats = _prepare_input_features(cyl, points[..., :2], points[..., 3:],
                                        c, vsize, lo, tgt, n_cells,
                                        point_valid)
        x = self._PPModel_0(feats, point_valid)
        if self.average_points:
            vf = dv.segment_mean(x, p2v, found, cap)
        else:
            vf = dv.segment_max(x, p2v, found, cap)
        if self.fea_compre:
            vf = F.relu(self.TorchLinear_0(vf))
        out = {"sparse_tensor": sp.SparseTensor(structure=struct,
                                                features=vf),
               "point_vcoors": c,
               "point_voxel_rows": torch.where(found, p2v, -1),
               "grid_size": (R, P, Z)}
        if (self.training and point_sem_labels is not None
                and self.voxel_label_enc):
            out["voxel_sem_labels"] = dv.segment_label_vote(
                point_sem_labels, p2v, found, cap, self.num_class)
        return out
