"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, keeps its own copy of the config schema in step with the
reference, and never falls back from the card to the CPU on its own."""

import ast
from dataclasses import asdict
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cikm2020_dmt_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "cikm2020_dmt_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    # the spawned ranks of the mesh tests import their module by name
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*torch*.py"))
            + sorted((ROOT / "tests").glob("torch_*workers.py")))


def test_port_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert "cikm2020_dmt_torch/ops/block.py" in names
    assert "cikm2020_dmt_torch/core/mesh.py" in names
    assert "cikm2020_dmt_torch/parallel/full_shard.py" in names
    assert "tests/torch_mesh_workers.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("conf", sorted((ROOT / "conf").glob("*.conf")),
                         ids=lambda p: p.name)
def test_config_copy_parses_like_reference(conf):
    from cikm2020_dmt_tpu.core.config import DMTConfig as JDMTConfig
    from cikm2020_dmt_torch.core.config import DMTConfig
    assert asdict(DMTConfig.from_ini(str(conf))) == asdict(
        JDMTConfig.from_ini(str(conf)))


def test_scorer_default_device_needs_cuda():
    """``Scorer`` defaults to the card and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.serve.export import Scorer
    cfg = DMTConfig.from_ini(str(ROOT / "conf" / "dmt.conf"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scorer(cfg, {}, [1.0], [0.0])


def test_block_wrapper_raises_off_cpu_and_cuda():
    """Only CPU tensors take the plain version: any other device raises
    instead of falling back."""
    from cikm2020_dmt_torch.ops.block import fused_encode_decode
    meta = torch.empty((2, 3, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_encode_decode({}, {}, enc_in=meta, dec_in=meta[:, 0],
                            seq_mask=meta[..., 0], num_heads=2)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from cikm2020_dmt_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_trainer_default_device_needs_cuda():
    """``Trainer`` defaults to the card and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.train.loop import Trainer
    cfg = DMTConfig.from_ini(str(ROOT / "conf" / "dmt.conf"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)


@pytest.mark.parametrize("name", ["sorted_segment_sum_rows", "update_rows",
                                  "update_rows_3d", "fused_block_bwd"])
def test_training_wrappers_raise_off_cpu_and_cuda(name):
    """The training kernels' wrappers, like the forward's, take the plain
    version only for CPU tensors and raise on any other device."""
    from cikm2020_dmt_torch.ops import block, scatter_rows
    meta = torch.empty((4, 3, 8), device="meta")
    ids = torch.empty((4,), dtype=torch.int64, device="meta")
    calls = {
        "sorted_segment_sum_rows": lambda: scatter_rows
        .sorted_segment_sum_rows(meta[:, 0], ids, ids, 4),
        "update_rows": lambda: scatter_rows.update_rows(meta[:, 0], ids,
                                                        meta[:, 0]),
        "update_rows_3d": lambda: scatter_rows.update_rows_3d(
            meta[:2], ids, meta[:, 0]),
        "fused_block_bwd": lambda: block.fused_block_bwd(
            (), (), enc_in=meta, dec_in=meta[:, 0], seq_mask=meta[..., 0],
            g=meta[:, 0], num_heads=2),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[name]()


# DMTConfig fields no module of the port reads, each with the reason it
# changes no value of the port
UNREAD_FIELDS = {
    "dedup_exact_rows_max": "routes a lookup to the reference's exact-dedup "
                            "gather, a TPU scatter cost (0, off, by default)",
    "total_example_num": "records the training data's size; nothing reads "
                         "it in either package",
    "checkpoint": "the [path] checkpoint key; nothing reads it in either "
                  "package",
}


def _attributes_read(paths) -> set:
    names = set()
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
    return names


def test_every_config_field_is_read_or_listed():
    """Each ``DMTConfig`` field is read (an attribute access) by some
    module of the port outside the config's own parser, or is one of
    ``UNREAD_FIELDS``; a listed field is read nowhere (a field that the
    port starts to read leaves the list)."""
    from dataclasses import fields

    from cikm2020_dmt_torch.core.config import DMTConfig
    read = _attributes_read(p for p in PORT.rglob("*.py")
                            if p != PORT / "core" / "config.py")
    names = {f.name for f in fields(DMTConfig)}
    assert set(UNREAD_FIELDS) <= names
    assert sorted(n for n in names - read) == sorted(UNREAD_FIELDS)
