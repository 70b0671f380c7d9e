"""One JAX train step of the mini MSeg3D config with the image branch in
bf16 (HRNet and FCNMSeg3DHead ``compute_dtype="bfloat16"``), run in a
FRESH interpreter: compiling the JAX package's bf16 convs on the XLA CPU
backend deep inside a long pytest process segfaults
(tests/_bf16_test_body.py). Writes a pickle of numpy trees: the random
Flax variables, the loss terms, the gradients (Adam's first moment over
1 - b1), Adam's second moment, the parameters and BN statistics after
the step; with ``--fp32`` the same step with the image branch in fp32
too, from the same variables and batch (the spread
tests/test_torch_port_bf16_train.py prints beside its readings).

    python tests/_torch_port_bf16_jax_step.py OUT.pkl [--fp32]
        [--batch-stats]

``--batch-stats``: HRNet's BN on batch statistics, as published.
"""

import copy
import os
import pickle
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", None)

from __graft_entry__ import _synthetic_mseg3d_batch  # noqa: E402
from lidarseg3d_tpu.apis import train as jtrain  # noqa: E402
from lidarseg3d_tpu.models import build_detector as jbuild  # noqa: E402
from lidarseg3d_tpu.solver.optim import (  # noqa: E402
    build_one_cycle_optimizer as jbuild_opt)
from lidarseg3d_tpu.utils.config import Config  # noqa: E402

from _torch_port_helpers import init_shapes, random_variables  # noqa: E402

B, V, N, IMG = 1, 512, 512, (64, 128)
OPT = dict(type="adam", wd=0.01)
LR = dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4)
TOTAL, CLIP = 10, 35.0
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
MINI = os.path.join(os.path.dirname(HERE), "configs", "tests",
                    "mini_semkitti_mseg3d.py")


def model_cfg(bf16, norm_eval=True):
    """The mini config's model: HRNet frozen_stages=3 (as the published
    configs), no s2d layout, dropout off; the image branch in bf16. HRNet's
    BN runs on its running statistics (``norm_eval``): at random weights
    batch statistics make the stage-4 gradient chaotic, and bf16 rounding
    would then decide it. The image head's BN keeps batch statistics."""
    cfg = Config.fromfile(MINI)
    model = copy.deepcopy(cfg.model.to_dict())
    model["img_backbone"].update(frozen_stages=3, s2d_max_c=0,
                                 norm_eval=norm_eval)
    model["point_head"]["model_cfg"]["DP_RATIO"] = 0
    if bf16:
        model["img_backbone"]["compute_dtype"] = "bfloat16"
        model["img_head"]["compute_dtype"] = "bfloat16"
    return cfg, model


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def step(bf16, variables=None, norm_eval=True):
    cfg, mcfg = model_cfg(bf16, norm_eval)
    pcr, vsz = cfg.point_cloud_range, cfg.voxel_size
    grid = np.round((np.asarray(pcr[3:]) - np.asarray(pcr[:3]))
                    / np.asarray(vsz)).astype(int)
    ishape = (int(grid[2]) + 1, int(grid[1]), int(grid[0]))
    jb = _synthetic_mseg3d_batch(B, V, N, img_hw=IMG, seed=5,
                                 with_labels=True, pcr=pcr, vsz=vsz)
    jm = jbuild(copy.deepcopy(mcfg))
    jex = {k: jnp.asarray(jb[k]) for k in jtrain.DEVICE_BATCH_KEYS}
    if variables is None:
        variables = random_variables(
            init_shapes(jm, dict(jex, input_shape=ishape), train=False),
            seed=1)
    tx, _ = jbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    fn = jax.jit(jtrain.make_train_step(jm, tx, ishape)).lower(
        state, jex).compile(compiler_options=FAST_COMPILE)
    new, losses = fn(state, jex)
    b1 = float(new.opt_state.hyperparams["b1"])
    adam = new.opt_state.inner_state[1]
    return variables, dict(
        losses={k: float(v) for k, v in losses.items()},
        grads=jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - b1),
                                     adam.mu),
        nu=np_tree(adam.nu),
        params=np_tree(new.params), batch_stats=np_tree(new.batch_stats))


def main(argv):
    out, norm_eval = {}, "--batch-stats" not in argv
    variables, out["bf16"] = step(True, norm_eval=norm_eval)
    out["variables"] = np_tree(variables)
    if "--fp32" in argv:
        _, out["fp32"] = step(False, variables, norm_eval)
    with open(argv[0], "wb") as f:
        pickle.dump(out, f)
    print("BF16-STEP-OK")


if __name__ == "__main__":
    main(sys.argv[1:])
