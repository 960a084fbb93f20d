"""The port stands alone: ``openess_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, and the port's own copy of the
settings parser reads every config as the JAX package's does."""
import ast
import dataclasses
import glob
import os
import subprocess
import sys

import pytest

from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "openess_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "openess_tpu")


def _port_files():
    files = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def test_port_imports_with_jax_blocked():
    """Every module imports with ``jax`` (and the packages the card machine
    may lack: yaml, PIL, pandas, triton, h5py, hdf5plugin) blocked, and no
    ``openess_tpu`` module gets loaded on the way."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "yaml", "PIL", "pandas", "triton",
             "h5py", "hdf5plugin"):
    sys.modules[name] = None
import openess_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    openess_tpu_torch.__path__, "openess_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "openess_tpu" or m.startswith("openess_tpu."))
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) >= 71  # every module through FC-CLIP


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and isinstance(
            node.args[0], ast.Constant
        ) and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set(_imported_roots(tree))
    assert not roots & set(FORBIDDEN), sorted(roots & set(FORBIDDEN))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_matplotlib_in_source(path):
    """The confusion plots are drawn with PIL: matplotlib is not needed
    where the port runs."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert "matplotlib" not in set(_imported_roots(tree))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_clip_packages_in_source(path):
    """FC-CLIP's tokenizer, backbone and decoders are the port's own: none
    of the packages the reference reaches them through (``regex``,
    ``ftfy``, ``open_clip``, ``timm``, ``detectron2``) is imported, and the
    card machine has none of them."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = set(_imported_roots(tree)) & {"regex", "ftfy", "open_clip", "timm",
                                        "detectron2"}
    assert not bad, sorted(bad)


def _port_sources():
    csrc = sorted(glob.glob(os.path.join(PORT, "csrc", "*")))
    return _port_files() + csrc


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_native_library_named(path):
    """No module of the port, no source under ``csrc/`` and not
    ``chip_smoke.py`` names the JAX package's native directory or its
    library: the port builds and loads its own copy."""
    with open(path) as f:
        text = f.read()
    for word in ("native/", "libevent_ops"):
        assert word not in text, word


def _code(path):
    """A C++ file without its comments and blank space."""
    import re

    with open(path) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    return "".join(text.split())


def test_host_source_is_a_copy_of_the_jax_package_one():
    """``csrc/event_ops.cpp`` is the JAX package's ``event_ops.cpp`` with
    its comments reworded and its code unchanged, so the two libraries
    built with the same flags compute the same bits."""
    port = _code(os.path.join(PORT, "csrc", "event_ops.cpp"))
    assert port == _code(os.path.join(ROOT, "native", "event_ops.cpp"))
    with open(os.path.join(PORT, "native.py")) as f:
        binding = f.read()
    for entry in ("voxelize_trilinear", "voxelize_trilinear_mt",
                  "voxelize_trilinear_windows", "voxelize_bilinear_t_windows",
                  "voxelize_bilinear_t", "event_histogram",
                  "time_indices_offsets", "chunk_events_phase_a",
                  "chunk_events_phase_b", "normalize_nonzero_inplace"):
        assert f'"{entry}"' in binding, entry


FLAGSHIP = "configs/pretrain/DSEC/frame2voxel_fcclip_slic.yaml"
# every shipped YAML
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_settings_match_jax_field_by_field(cfg):
    from openess_tpu.config.settings import load_settings as jload
    from openess_tpu_torch.config.settings import load_settings as tload

    js, ts = jload(os.path.join(ROOT, cfg)), tload(os.path.join(ROOT, cfg))
    for f in dataclasses.fields(js):
        if f.name == "logger":
            continue
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if f.name == "semseg_color_map":
            assert (a == b).all()
        else:
            assert a == b, (f.name, a, b)
    assert [f.name for f in dataclasses.fields(ts)] == [
        f.name for f in dataclasses.fields(js)
    ]


def test_chip_smoke_settings_are_the_flagship_yaml():
    """chip_smoke.py builds its settings in code (no PyYAML on the card
    machine); they must equal the flagship YAML's."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from openess_tpu_torch.config.settings import load_settings

    ref = load_settings(os.path.join(ROOT, FLAGSHIP))
    got = chip_smoke.flagship_settings()
    for f in dataclasses.fields(ref):
        if f.name in ("logger", "semseg_color_map"):
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("make,cfg,changed", [
    ("finetune_settings",
     "configs/finetunes/DSEC/slic/frame2recon_fcclip_slic_100.yaml",
     dict(config_option="frame2voxel")),
    ("ddd17_probe_settings",
     "configs/linear_probe/DDD17/frame2voxel_fcclip_slic.yaml",
     dict(if_pretraining=False)),
    ("recon_pretrain_settings",
     "configs/pretrain/DSEC/frame2recon_fcclip_slic.yaml", {}),
    ("uda_recon_settings",
     "configs/linear_probe/DSEC/frame2recon_fcclip_sam.yaml", {}),
])
def test_chip_smoke_downstream_settings_are_their_yamls(make, cfg, changed):
    """The fine-tune YAML run on the event path, the DDD17 linear-probe
    YAML with ``if_pretraining`` off, and the ``frame2recon`` pretrain and
    UDA YAMLs as shipped, as chip_smoke.py builds them in code."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from openess_tpu_torch.config.settings import load_settings

    ref = dataclasses.replace(load_settings(os.path.join(ROOT, cfg)),
                              **changed)
    got = getattr(chip_smoke, make)()
    for f in dataclasses.fields(ref):
        if f.name in ("logger", "semseg_color_map"):
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


NEW_MODULES = [
    "losses", "metrics", "train", "test", "data.augment", "data.loaders",
    "data.synthetic", "models.image_teacher", "models.resnet",
    "ops.confusion", "ops.segment_pool", "training.checkpoint",
    "training.optim", "training.steps", "training.trainer",
    "data.ddd17",  # the third slice: the event half of the DDD17 loader
    # the fourth slice: the grid wire and the datasets read from disk
    "data.dsec", "data.event_slicer", "data.png", "ops.voxelize",
    "ops.voxelize_mxu",
    # the ninth slice: the host C++'s binding and the prefetching loader
    "native", "data.pipeline",
    # the tenth slice: the bench, released checkpoints, profiling, FLOPs
    # and the qualitative dumps
    "bench", "convert_checkpoints", "utils.profiling", "utils.flops",
    "utils.viz",
    # the eleventh slice: the serving export
    "export_model",
    # the thirteenth slice: FC-CLIP and the assets' preflight
    "models.fcclip.backbone", "models.fcclip.convert",
    "models.fcclip.inference", "models.fcclip.manifest", "models.fcclip.meta",
    "models.fcclip.pixel_decoder", "models.fcclip.tokenizer",
    "models.fcclip.transformer_decoder", "ops.ms_deform_attn", "preflight",
]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_training_slice_module_is_scanned(name):
    """Every module of the training slice exists where its JAX counterpart
    does and is among the files the source scan covers."""
    rel = os.path.join(*name.split("."))
    cands = (os.path.join(PORT, rel + ".py"),
             os.path.join(PORT, rel, "__init__.py"))
    assert any(c in _port_files() for c in cands), name


def test_kernel_sources_are_in_the_package():
    """Each CUDA kernel's source is a file of the package (built at first
    use from there), its C entries are there, and its wrapper names it;
    K1 and K4 share a source, as K5 and K6 do, and K3's forward and
    backward; all four voxelizers (K1, K4, K5, K6) include the tile-owner
    splat's header. No Triton
    kernel is left: the port needs no ``triton``."""
    entries = {
        "voxelize_chunked.cu": ("ops/voxelize_chunked.py",
                                ("voxelize_chunked_trilinear",
                                 "voxelize_chunked_bilinear_t")),
        "segment_pool.cu": ("ops/segment_pool.py", ()),
        "voxelize_grid.cu": ("ops/voxelize_mxu.py",
                             ("bin_events_trilinear",
                              "splat_binned_trilinear",
                              "bin_events_bilinear_t",
                              "splat_binned_bilinear_t")),
        "lstm_gates.cu": ("ops/lstm_gates.py",
                          ("lstm_gates_forward", "lstm_gates_backward")),
    }
    for source, (wrapper, names) in entries.items():
        with open(os.path.join(PORT, "csrc", source)) as f:
            cu = f.read()
        for entry in names:
            assert f'extern "C" int {entry}(' in cu
        with open(os.path.join(PORT, wrapper)) as f:
            assert f'_build.entry("{source}"' in f.read()
    for source in ("voxelize_chunked.cu", "voxelize_grid.cu"):
        with open(os.path.join(PORT, "csrc", source)) as f:
            assert '#include "tile_splat.cuh"' in f.read()
    for path in _port_files():
        with open(path) as f:
            text = f.read()
        assert "@triton.jit" not in text, path
        assert "triton" not in set(_imported_roots(ast.parse(text))), path


def test_chip_smoke_reads_registers_and_spills_from_the_ptxas_log(tmp_path):
    """The build phase's ``-Xptxas -v`` summary: one row per kernel with
    its registers and spilled bytes, named whether or not ``c++filt``
    can demangle it."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    (tmp_path / "libk.log").write_text(
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__cabc5852"
        "_16_voxelize_grid_cu_8d4f385516bil_splat_eventsEPKfS1_S1_S1_Pfxiiiii"
        "' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 22 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_Z14lstm_gates_bwdI13__nv_"
        "bfloat16Li8ELi1EEvPKT_S3_S3_S3_PS1_S4_ji' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 76 registers, used 0 barriers\n")
    rows = chip_smoke.ptxas_kernels(str(tmp_path / "libk.so"))
    assert [r[1:] for r in rows] == [(22, 0), (76, 12)]
    assert rows[0][0] == "bil_splat_events"
    assert "lstm_gates_bwd" in rows[1][0]


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """With no CUDA device the smoke run exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=str(tmp_path),
                       env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
