"""The port's checkpoint reader and weight bridge against flax and the JAX
package's importer; the port's import boundary; its device guard."""

import ast
import os
import subprocess
import sys

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from pointdsc_tpu.compat.torch_weights import from_torch_state_dict
from pointdsc_tpu_torch import PointDSC, load_pretrained, register
from pointdsc_tpu_torch._device import full_f32_matmul
from pointdsc_tpu_torch.compat import flax_msgpack
from pointdsc_tpu_torch.compat.weights import (
    from_flax_variables,
    from_torch_reference_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAP = os.path.join(ROOT, "snapshot", "PointDSC_Synthetic_release")
CKPT = os.path.join(SNAP, "models", "model_best.pkl")


def leaves(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


@pytest.fixture(scope="module")
def restored():
    with open(CKPT, "rb") as f:
        data = f.read()
    return serialization.msgpack_restore(data), flax_msgpack.loads(data)


def test_msgpack_reader_matches_flax(restored):
    """Every leaf of the snapshot, exactly: same tree, dtype, shape, bytes."""
    ref, out = restored
    ref_leaves = dict(leaves(ref))
    out_leaves = dict(leaves(out))
    assert ref_leaves.keys() == out_leaves.keys()
    arrays = 0
    for path, want in ref_leaves.items():
        got = out_leaves[path]
        if isinstance(want, np.ndarray):
            arrays += 1
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
            np.testing.assert_array_equal(got, want)
        else:
            assert type(got) is type(want) and got == want, path
    assert arrays == 822


def test_msgpack_reader_scalar_types():
    """The plain msgpack types beside flax's ndarray extension."""
    obj = {"s": "x" * 40, "neg": -5, "big": 2**40, "i8": -100, "f": 0.25, "none": None,
           "t": True, "f0": False, "bin": b"\x00\x01", "list": [1, 2, 3],
           "arr": np.arange(6, dtype=np.int32).reshape(2, 3)}
    data = serialization.msgpack_serialize(obj)
    back = flax_msgpack.loads(data)
    arr = back.pop("arr")
    np.testing.assert_array_equal(arr, obj.pop("arr"))
    assert back == obj
    with pytest.raises(ValueError):
        flax_msgpack.loads(msgpack.packb(1) + b"\x00")


def test_from_flax_variables_round_trips_every_key(restored):
    """Each flax leaf lands on exactly one state-dict key of the port's
    model (Dense kernels transposed), and every key of the model is filled."""
    raw, _ = restored
    variables = {"params": raw["params"], "batch_stats": raw["batch_stats"]}
    state = from_flax_variables(variables)
    model = PointDSC(device="cpu")
    assert set(state) == set(model.state_dict())
    names = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean",
             "var": "running_var", "sigma": "sigma"}
    seen = set()
    for collection in ("params", "batch_stats"):
        for path, value in leaves(variables[collection]):
            key = ".".join(path[:-1] + (names[path[-1]],))
            want = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                want = want.T
            np.testing.assert_array_equal(state[key].numpy(), want)
            seen.add(key)
    assert seen == set(state)
    model.load_state_dict(state, strict=True)


def test_from_torch_reference_state_dict_matches_jax_importer(rng):
    """The port's copy of the reference-checkpoint importer gives the JAX
    package's variables tree, leaf for leaf."""
    layers, c = 2, 16
    sd = {"sigma": rng.normal(size=(1,)), "sigma_spat": rng.normal(size=(1,)),
          "encoder.layer0.weight": rng.normal(size=(c, 6, 1)),
          "encoder.layer0.bias": rng.normal(size=(c,))}

    def conv(prefix, cin, cout):
        sd[f"{prefix}.weight"] = rng.normal(size=(cout, cin, 1))
        sd[f"{prefix}.bias"] = rng.normal(size=(cout,))

    def bn(prefix, ch):
        for name in ("weight", "bias", "running_mean"):
            sd[f"{prefix}.{name}"] = rng.normal(size=(ch,))
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, size=(ch,))

    for i in range(layers):
        conv(f"encoder.blocks.PointCN_layer_{i}.0", c, c)
        bn(f"encoder.blocks.PointCN_layer_{i}.1", c)
        nl = f"encoder.blocks.NonLocal_layer_{i}"
        for p in ("q", "k", "v"):
            conv(f"{nl}.projection_{p}", c, c)
        conv(f"{nl}.fc_message.0", c, c // 2)
        bn(f"{nl}.fc_message.1", c // 2)
        conv(f"{nl}.fc_message.3", c // 2, c // 2)
        bn(f"{nl}.fc_message.4", c // 2)
        conv(f"{nl}.fc_message.6", c // 2, c)
    conv("classification.0", c, 32)
    conv("classification.2", 32, 32)
    conv("classification.4", 32, 1)

    ref = dict(leaves(from_torch_state_dict(sd, layers)))
    out = dict(leaves(from_torch_reference_state_dict(sd, layers)))
    assert ref.keys() == out.keys()
    for path in ref:
        np.testing.assert_array_equal(out[path], ref[path])
    model = PointDSC(num_layers=layers, num_channels=c, device="cpu")
    model.load_state_dict(from_flax_variables(from_torch_reference_state_dict(sd, layers)),
                          strict=True)
    with pytest.raises(KeyError):
        from_torch_reference_state_dict({k: v for k, v in sd.items() if k != "sigma"}, layers)


def test_port_imports_no_jax():
    """Importing the port (every module of it) and chip_smoke.py pulls in
    nothing of pointdsc_tpu, jax or flax, nor PIL (the card's machine has
    no PIL: the RGB-D fragments' PNG frames go through data/png.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pointdsc_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'pointdsc_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('eval.runner', 'eval.protocol', 'eval.metrics', 'utils.timer',\n"
        "             'models.regime', 'kernels.encoder_layer', 'tools.regime_scan',\n"
        "             'tools.profile_forward', 'train.config', 'train.losses',\n"
        "             'train.trainer', 'kernels.sm_loss', 'utils.logging', 'utils.seed',\n"
        "             'tools.train_synthetic', 'tools.profile_train_step',\n"
        "             'kernels.nn_search', 'kernels.symcache', 'ops.icp', 'ops.matching',\n"
        "             'descriptors.fpfh', 'data.ply', 'tools.demo_registration',\n"
        "             'tools.exp_symcache', 'native', 'baselines.classical',\n"
        "             'baseline_scripts._runner', 'baseline_scripts.baseline_3DMatch',\n"
        "             'baseline_scripts.baseline_KITTI', 'ops.lie', 'multiway',\n"
        "             'multiway.pose_graph', 'multiway.ate', 'multiway.registration',\n"
        "             'multiway._cli', 'multiway.make_fragments', 'multiway.test_multi',\n"
        "             'multiway.test_multi_ate', 'data.redwood', 'data.png',\n"
        "             'eval.redwood_protocol', 'fusion', 'fusion.camera', 'fusion.odometry',\n"
        "             'fusion.tsdf', 'fusion.fragments'):\n"
        "    assert 'pointdsc_tpu_torch.' + name in names, name\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('pointdsc_tpu', 'jax', 'jaxlib', 'flax', 'PIL'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax():
    """No file of the package (tools included) nor chip_smoke.py names
    pointdsc_tpu, jax or flax in an import statement, even one that the
    import test above never executes (inside a function, behind a flag); PIL
    only inside a function (``fusion/fragments.py``'s JPEG reader)."""
    forbidden = {"pointdsc_tpu", "jax", "jaxlib", "flax", "optax"}
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "pointdsc_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    rel = {os.path.relpath(f, os.path.join(ROOT, "pointdsc_tpu_torch")) for f in files}
    for name in ("eval/runner.py", "eval/protocol.py", "eval/metrics.py", "utils/timer.py",
                 "models/regime.py", "kernels/encoder_layer.py", "tools/regime_scan.py",
                 "train/config.py", "train/losses.py", "train/trainer.py", "kernels/sm_loss.py",
                 "utils/logging.py", "utils/seed.py", "tools/train_synthetic.py",
                 "tools/profile_train_step.py", "kernels/nn_search.py", "kernels/symcache.py",
                 "ops/icp.py", "ops/matching.py", "descriptors/fpfh.py", "data/ply.py",
                 "tools/demo_registration.py", "tools/exp_symcache.py", "native/__init__.py",
                 "baselines/classical.py", "baseline_scripts/_runner.py",
                 "baseline_scripts/baseline_3DMatch.py", "baseline_scripts/baseline_KITTI.py",
                 "ops/lie.py", "multiway/pose_graph.py", "multiway/ate.py",
                 "multiway/registration.py", "multiway/_cli.py", "multiway/make_fragments.py",
                 "multiway/test_multi.py", "multiway/test_multi_ate.py", "data/redwood.py",
                 "data/png.py", "eval/redwood_protocol.py", "fusion/camera.py",
                 "fusion/odometry.py", "fusion/tsdf.py", "fusion/fragments.py"):
        assert name in rel, name
    bad = []
    pil = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in forbidden]
            if any(n.split(".")[0] == "PIL" for n in names):
                pil.append((os.path.relpath(path, ROOT), node.lineno))
        # PIL only inside a function: fusion/fragments.py's JPEG frames
        for func in ast.walk(tree):
            if isinstance(func, ast.FunctionDef):
                lines = {n.lineno for n in ast.walk(func) if isinstance(n, (ast.Import,
                                                                            ast.ImportFrom))}
                pil = [(f, ln) for f, ln in pil
                       if not (f == os.path.relpath(path, ROOT) and ln in lines)]
    assert not bad, bad
    assert not pil, pil


def test_full_f32_matmul_scopes_the_tf32_flags():
    """The forward turns TF32 off only while it runs, and restores the
    caller's flags afterwards, also when the block raises."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = True, True
        with pytest.raises(KeyError):
            with full_f32_matmul():
                assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, False)
                raise KeyError("inside")
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
        model = PointDSC(num_layers=1, num_channels=16, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        pts = torch.rand((1, 32, 3), generator=torch.Generator().manual_seed(1))
        model(torch.cat([pts, pts], dim=-1), pts, pts, fused=False)
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """Without CUDA, an entry point raises unless the caller asks for the
    CPU; it never drops to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PointDSC(num_layers=1, num_channels=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_pretrained(SNAP)
    model = PointDSC(num_layers=1, num_channels=16, device="cpu")
    pts = np.zeros((16, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        register(np.zeros((16, 6), np.float32), pts, pts, model=model)
