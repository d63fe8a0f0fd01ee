"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the reference package, and the port's
model configurations equal the reference's field for field."""
import ast
import dataclasses
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            yield node.lineno, node.args[0].value


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("core/lut.py", "kernels/lutmul/ops.py",
                "kernels/lutmul/kernel.py", "models/transformer.py",
                "serve/engine.py", "serve/scheduler.py", "serve/paged.py",
                "ckpt/checkpoint.py", "convert.py",
                "core/quantization.py", "core/thresholds.py",
                "core/streamline.py", "kernels/thresholds/ref.py",
                "kernels/thresholds/kernel.py", "kernels/thresholds/ops.py",
                "models/mobilenet.py", "configs/mobilenetv2.py",
                "configs/gemma2_2b.py", "configs/phi3_medium_14b.py",
                "configs/minicpm_2b.py", "models/moe.py",
                "configs/qwen2_moe_a2p7b.py", "configs/mixtral_8x22b.py",
                "models/ssm.py", "configs/rwkv6_1p6b.py",
                "configs/zamba2_2p7b.py", "models/encdec.py",
                "configs/whisper_large_v3.py", "configs/qwen2_vl_72b.py",
                "dist/mesh.py", "dist/tp.py", "serve/sharded.py",
                "dist/straggler.py", "data/pipeline.py", "optim/adamw.py",
                "optim/schedules.py", "optim/grad_compress.py",
                "train/step.py", "train/loop.py", "core/tree.py",
                "core/fpga_model.py", "roofline/analysis.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for src in ("thresholds.cu", "lutmul_gather.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / src).is_file(), src


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_never_imports_jax_or_reference(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_import_detector():
    src = ("import jax.numpy as jnp\nfrom repro.core import lut\n"
           "import repro_torch\nfrom jax import lax\n")
    tree = ast.parse(src)
    names = [n.names[0].name if isinstance(n, ast.Import) else n.module
             for n in tree.body]
    assert [_forbidden(n) for n in names] == [True, True, False, True]


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_qwen2_7b_config_fields_match_reference(fn, quant):
    from repro.configs import qwen2_7b as jcfg
    from repro_torch.configs import qwen2_7b as tcfg
    want = dataclasses.asdict(getattr(jcfg, fn)(quant=quant))
    got = dataclasses.asdict(getattr(tcfg, fn)(quant=quant))
    assert got == want


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
def test_bitnet_3b_config_fields_match_reference(fn):
    from repro.configs import bitnet_3b as jcfg
    from repro_torch.configs import bitnet_3b as tcfg
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import check_supported
    want = dataclasses.asdict(getattr(jcfg, fn)())
    got = getattr(tcfg, fn)()
    assert dataclasses.asdict(got) == want
    assert get_config("bitnet-3b", smoke=fn == "smoke_config") == got
    check_supported(got)


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
@pytest.mark.parametrize("quant", ["qat", "none"])
def test_mobilenetv2_config_fields_match_reference(fn, quant):
    from repro.configs import get_config as jget_config
    from repro.configs import mobilenetv2 as jcfg
    from repro_torch.configs import get_config
    from repro_torch.configs import mobilenetv2 as tcfg
    want = dataclasses.asdict(getattr(jcfg, fn)(quant=quant))
    got = getattr(tcfg, fn)(quant=quant)
    assert dataclasses.asdict(got) == want
    smoke = fn == "smoke_config"
    assert get_config("mobilenetv2", smoke=smoke, quant=quant) == got
    assert dataclasses.asdict(jget_config("mobilenetv2", smoke=smoke,
                                          quant=quant)) == want


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_recurrent_config_fields_match_reference(arch, fn):
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import check_supported
    smoke = fn == "smoke_config"
    want = dataclasses.asdict(jget_config(arch, smoke=smoke,
                                          quant="w4a4_lut"))
    got = get_config(arch, smoke=smoke, quant="w4a4_lut")
    assert dataclasses.asdict(got) == want
    check_supported(got)
