"""Hygiene of the port: lidarseg3d_torch (its solver, apis, losses,
datasets, the train pipeline's augmentations, colour-space and JPEG
modules, the nuScenes dataset, info builder and JPEG reader, SegNet's
reader, head and segmentor, the multi-process runtime, the detection
stack (CenterPoint's VoxelNet and PointPillars, their pipeline, metrics
and writers; the two-stage detector, tracking, the C voxelizer's loader,
the point operations, the FLOP counter, the logger and the single-frame
tools; UNetCylinder3D, tools.warm_cache and tools.synthetic_e2e), and
tools included), chip_smoke.py and the profile_*.py scripts import nothing of
JAX, Flax, optax, the JAX package or __graft_entry__, and no image
library (cv2, PIL, imageio: the card's machine has none); the entry
points run on cuda unless told otherwise; the constants the CPU
emulations read from the kernel wrappers are the kernel sources' own."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lidarseg3d_tpu",
             "__graft_entry__", "cv2", "PIL", "imageio")
TRAINING_MODULES = ("solver/optim.py", "apis/train.py", "ops/losses.py",
                    "ops/rulebook_conv.py", "utils/remat.py")
EVAL_MODULES = ("tools/test.py", "apis/eval.py", "core/seg_metrics.py",
                "datasets/loader.py", "datasets/batching.py",
                "datasets/pipelines/loading.py", "datasets/pipelines/png.py",
                "datasets/pipelines/img_transforms.py",
                "datasets/pipelines/seg_preprocess.py",
                "datasets/semantickitti/dataset.py", "parallel/dist.py")
TRAIN_ENTRY_MODULES = ("tools/train.py", "core/augment.py",
                       "core/voxelize.py", "datasets/pipelines/jpeg.py",
                       "datasets/pipelines/colorspace.py")
NUSC_MODULES = ("datasets/nuscenes/metadata.py",
                "datasets/nuscenes/splits.py",
                "datasets/nuscenes/common.py",
                "datasets/nuscenes/dataset.py", "datasets/validate.py",
                "datasets/pipelines/jpeg_read.py", "tools/create_data.py",
                "synthetic.py")
SEGNET_MODULES = ("models/readers/voxel_encoders.py",
                  "models/point_heads/batchloss_head.py",
                  "models/segmentors/seg_net.py", "convert.py")
POLAR_MODULES = ("apis/pretrain.py", "tools/convert_hrnet_checkpoint.py",
                 "ops/dynamic_voxel.py", "models/readers/dynamic_vfe.py",
                 "models/backbones/cylinder3d.py",
                 "models/backbones/polarnet_unet.py",
                 "models/point_heads/polarnet_head.py",
                 "models/segmentors/seg_polarnet.py", "utils/tb_logger.py")
DIST_MODULES = ("parallel/mesh.py", "models/layers.py",
                "models/point_heads/mseg3d_head.py")
WAYMO_MODULES = ("datasets/waymo/__init__.py", "datasets/waymo/dataset.py",
                 "datasets/waymo/converter.py",
                 "datasets/waymo/submission.py",
                 "datasets/pipelines/instance_aug.py",
                 "models/img_heads/sc_conv.py", "models/img_heads/fcn_head.py",
                 "models/img_backbones/resnet.py")
DET_MODULES = ("core/box_np_ops.py", "core/center_targets.py",
               "core/det_metrics.py", "ops/box_ops.py",
               "datasets/pipelines/det_pipeline.py",
               "datasets/nuscenes/det_submission.py",
               "datasets/waymo/det_submission.py",
               "models/backbones/scn_det.py", "models/necks/__init__.py",
               "models/necks/rpn.py", "models/bbox_heads/__init__.py",
               "models/bbox_heads/center_head.py",
               "models/readers/pillar_encoder.py",
               "models/segmentors/voxelnet.py",
               "models/segmentors/point_pillars.py", "apis/det_eval.py")
SLICE15_MODULES = ("models/second_stage/bev_extractor.py",
                   "models/roi_heads/roi_head.py",
                   "models/segmentors/two_stage.py",
                   "tracking/__init__.py", "tracking/tracker.py",
                   "tools/nusc_tracking.py", "tools/waymo_tracking.py",
                   "core/native_voxelize.py", "ops/pointnet2.py",
                   "utils/flops.py", "utils/log.py",
                   "tools/single_inference.py",
                   "tools/simple_inference_waymo.py", "tools/visual.py",
                   "tools/instance_preprocess.py")
SLICE16_MODULES = ("models/backbones/unet_scn.py", "tools/warm_cache.py",
                   "tools/synthetic_e2e.py")
SCRIPTS = ("chip_smoke.py", "profile_build.py", "profile_convs.py",
           "profile_merge.py", "profile_train_precision.py")


def _files():
    return sorted((ROOT / "lidarseg3d_torch").rglob("*.py")) + [
        ROOT / s for s in SCRIPTS]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = _files()
    assert len(files) > 20
    listed = {str(p.relative_to(ROOT / "lidarseg3d_torch"))
              for p in files[:-len(SCRIPTS)]}
    wanted = (set(TRAINING_MODULES) | set(EVAL_MODULES)
              | set(TRAIN_ENTRY_MODULES) | set(NUSC_MODULES)
              | set(SEGNET_MODULES) | set(POLAR_MODULES)
              | set(DIST_MODULES) | set(WAYMO_MODULES) | set(DET_MODULES)
              | set(SLICE15_MODULES) | set(SLICE16_MODULES))
    assert wanted <= listed, wanted - listed
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_imports_are_checked_in_function_bodies_too(tmp_path):
    """The AST walk sees imports inside functions (the entry point imports
    lazily), so a forbidden one there is caught."""
    p = tmp_path / "lazy.py"
    p.write_text("def f():\n    import cv2\n    from PIL import Image\n")
    assert {"cv2", "PIL"} <= set(_imports(p))


def test_build_detector_defaults_to_cuda():
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.synthetic import mseg3d_model_cfg

    cfg = mseg3d_model_cfg(ratio=1, small_hrnet=True)
    if torch.cuda.is_available():
        m = build_detector(cfg)
        assert next(m.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_detector(cfg)


@pytest.mark.parametrize("tool", ["single_inference",
                                  "simple_inference_waymo"])
def test_single_frame_tools_default_to_cuda(tool, tmp_path):
    """The single-frame tools run on cuda unless --device cpu is given,
    and raise without a card (before they read anything)."""
    import importlib

    mod = importlib.import_module(f"lidarseg3d_torch.tools.{tool}")
    flag = "--scan" if tool == "single_inference" else "--frame"
    argv = [str(tmp_path / "none.py"), "--checkpoint", str(tmp_path), flag,
            str(tmp_path / "none.bin")]
    assert mod.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(argv)


@pytest.mark.parametrize("tool,argv", [
    ("warm_cache", ["configs/tests/mini_semkitti_mseg3d.py"]),
    ("synthetic_e2e", [])])
def test_slice16_tools_default_to_cuda(tool, argv):
    """tools.warm_cache and tools.synthetic_e2e run on cuda unless
    --device cpu is given, and raise without a card (before they write
    or build anything)."""
    import importlib

    mod = importlib.import_module(f"lidarseg3d_torch.tools.{tool}")
    assert mod.parse_args(argv).device == "cuda"
    assert mod.parse_args(argv + ["--device", "cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([str(ROOT / a) for a in argv])


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """A wrapper given a tensor on another device raises instead of
    falling back."""
    from lidarseg3d_torch.ops.rank_pack import pack_rank_table

    with pytest.raises(ValueError):
        pack_rank_table(torch.zeros(1, 8, dtype=torch.int8, device="meta"),
                        8)


@pytest.mark.parametrize("name", ["rulebook_conv", "rulebook_conv_dw"])
def test_conv_wrappers_refuse_other_devices(name):
    """The conv's forward and dW wrappers launch a kernel or raise: a
    tensor that is neither on the CPU nor on a CUDA device is refused."""
    from lidarseg3d_torch.ops import rulebook_conv as rc

    feat = torch.zeros(9, 4, device="meta")
    rb = torch.zeros(27, 1, 8, dtype=torch.int32, device="meta")
    other = torch.zeros(27, 4, 4, device="meta") if name == "rulebook_conv" \
        else torch.zeros(8, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(rc, name)(feat, rb, other)


def test_every_kernel_source_is_registered():
    from lidarseg3d_torch.ops import cuda_build

    on_disk = {p.name for p in cuda_build.CSRC.glob("*.cu")}
    assert on_disk == set(cuda_build.SOURCES.values())
    assert len(on_disk) == 5


def test_every_host_source_is_registered():
    """Every host C source (the JPEG entropy coder, the voxelizer) is
    built by cuda_build."""
    from lidarseg3d_torch.ops import cuda_build

    on_disk = {p.name for p in cuda_build.CSRC.glob("*.c")}
    assert on_disk == set(cuda_build.HOST_SOURCES.values()) == {
        "jpeg_huffman.c", "voxelize.c"}


def _cu_ints(name):
    """The integer constants of a kernel source: constexpr ints and the
    defaults of its -D overridable macros."""
    import re

    from lidarseg3d_torch.ops import cuda_build

    src = (cuda_build.CSRC / name).read_text()
    vals = {m[0]: int(m[1]) for m in re.findall(
        r"^#define (\w+) (\d+)$", src, re.M)}
    vals.update({m[0]: vals[m[1]] if m[1] in vals else int(m[1])
                 for m in re.findall(r"constexpr int (\w+) = (\w+);", src)})
    return vals


def test_wrapper_constants_match_kernel_sources():
    """The constants the CPU emulations of the pack and merge kernels read
    from the wrappers are the kernels' own."""
    from lidarseg3d_torch.ops import merge_lookup as ml
    from lidarseg3d_torch.ops import rank_pack as rp

    pk = _cu_ints("rank_pack.cu")
    assert (rp.THREADS, rp.TILE, rp.HEADER) == (
        pk["kThreads"], pk["kThreads"] * pk["kGroups"] * 4, pk["kHeader"])
    mg = _cu_ints("merge_lookup.cu")
    assert (ml.THREADS, ml.KPER, ml.WINDOW) == (
        mg["kThreads"], mg["kPer"], mg["kWindow"])
