"""``chip_smoke.py`` and the device/cache helpers it stands on, on the CPU.

The phases run here at a tiny size through the same functions the script
runs at ViT-L width on the card; the device check must refuse the CPU.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from vitax.utils import device as dev
from vitax.utils import health

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2,
            heads=4, mlp_dim=128, dim_head=16)
SIZES = dict(serve_batch=8, requests=6, decode_size=40, images=4,
             train_batch=8, train_steps=5, mesh_train_batch=8)


@pytest.fixture(scope="module")
def built():
    model, variables = cs.build(TINY, jnp.bfloat16, seed=0)
    return model, variables


def test_serve_phase_tiny(built):
    out = cs.phase_serve(*built, TINY, SIZES, seed=0)
    assert out["requests"] == SIZES["requests"]
    assert out["decoder_backend"] in ("native", "pil")
    assert out["server_vs_pipeline"]["max_abs_over_max_logit"] <= cs.TOL["bf16_vs_fp64"]


def test_correctness_phase_tiny(built):
    out, imgs, bf16 = cs.phase_correctness(*built, TINY, SIZES, seed=0)
    assert imgs.shape == (SIZES["images"], 32, 32, 3)
    assert bf16.shape == (SIZES["images"], 10)
    assert out["fp32_highest_vs_fp64"]["max_abs_over_max_logit"] < 1e-5


def test_int8_phase_tiny(built):
    _, imgs, bf16 = cs.phase_correctness(*built, TINY, SIZES, seed=0)
    out = cs.phase_int8(*built, TINY, SIZES, imgs, bf16, seed=0)
    assert out["auto_b1"]["resolves_to"] == "w8"
    assert out["auto_b8"]["resolves_to"] == "w8"
    assert out["w8a8_b8"]["s8_s32_gemms"] >= 4


def test_train_phase_tiny():
    out = cs.phase_train(TINY, SIZES, seed=0)
    assert len(out["losses"]) == SIZES["train_steps"]
    assert out["losses"][-1] < out["losses"][0]


def test_four_card_phase_tiny_on_virtual_devices():
    assert len(jax.devices()) >= 4
    out = cs.run(TINY, SIZES, chips=4)["four_cards"]
    train = out["train"]
    assert train["mesh"] == {"data": 2, "model": 2}
    assert train["grad_gap_mesh"]["global"] <= cs.TOL["mesh_grad_gap"]
    assert train["grad_gap_planted_fault"]["global"] > cs.TOL["mesh_grad_gap"]


def test_gradient_gap_reads_sgd_steps():
    p0 = {"a": np.ones((3, 2), np.float32), "b": np.zeros(4, np.float32)}
    g = {"a": np.full((3, 2), 0.5, np.float32), "b": np.arange(4, dtype=np.float32)}
    new = {k: p0[k] - g[k] for k in p0}
    got = cs.step_gradients(p0, new)
    np.testing.assert_array_equal(got[0], g["a"])
    np.testing.assert_array_equal(got[1], g["b"])
    assert cs.gradient_gap(got, got) == {"global": 0.0, "worst_leaf": 0.0}
    off = [got[0], 2 * got[1]]
    gap = cs.gradient_gap(off, got)
    assert gap["global"] == pytest.approx(np.sqrt(14 / (1.5 + 14)))
    assert gap["worst_leaf"] == pytest.approx(1.0)


def test_compare_bounds_the_error_relative_to_max_logit():
    ref = np.array([[1.0, 0.99, -1.0], [1.0, 0.0, -1.0]])
    ok = cs.compare("near tie", ref + [[-0.01, 0.01, 0.0], [0, 0, 0]], ref, 0.05)
    assert ok["top1_agree"] == "1/2"
    assert ok["max_abs_over_max_logit"] == pytest.approx(0.01)
    with pytest.raises(cs.SmokeFailure, match="limit"):
        cs.compare("too far", ref * 1.2, ref, 0.05)
    with pytest.raises(cs.SmokeFailure, match="non-finite"):
        cs.compare("nan", ref * np.nan, ref, 0.05)


def test_int8_gemm_count_reads_operand_types():
    hlo = "\n".join([
        "%a = s8[8,64]{1,0} parameter(0)",
        "%b = s8[64,32]{1,0} parameter(1)",
        "%f = f32[8,64]{1,0} convert(%a)",
        "%dot.1 = s32[8,32]{1,0} dot(%a, %b), lhs_contracting_dims={1}",
        "%gemm = (s32[8,32]{1,0}, s8[1024]{0}) custom-call(%a, %b), custom_call_target=\"__cublas$lt$matmul\"",
        "%widened = f32[8,32]{1,0} dot(%f, %f)",
        "ROOT %fusion.2 = s32[8,32]{1,0} fusion(%a, %b), kind=kCustom",
    ])
    assert cs.int8_gemms(hlo) == 3


def test_device_check_refuses_the_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(dev.NoAcceleratorError, match="no GPU"):
        dev.require_gpu()
    assert dev.device_record() == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind, "count": len(jax.devices()),
    }


def test_peak_table_knows_the_h100_and_refuses_unknown_cards():
    peaks = dev.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flops_per_s"] == 989e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError, match="no published peaks"):
        dev.device_peaks("cpu")


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_script_exits_nonzero_without_a_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = os.path.join(REPO, ".jax_cache")
    else:
        expected = str(tmp_path / "cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expected)
    assert health.compilation_cache_dir() == expected
    prior = jax.config.jax_compilation_cache_dir
    try:
        assert health.enable_compilation_cache() == expected
        assert jax.config.jax_compilation_cache_dir == expected
        assert os.path.isdir(expected)
    finally:
        jax.config.update("jax_compilation_cache_dir", prior)
    # the same call twice names the same directory: nothing per-process
    assert health.compilation_cache_dir() == health.compilation_cache_dir()


def test_vendored_flax_runs_the_model():
    """vitax runs on its vendored Flax alone: in a fresh interpreter where
    a top-level ``flax`` cannot be imported, the model builds and runs, and
    nothing imported one."""
    code = f"""
import sys
class Refuse:
    def find_spec(self, name, path, target=None):
        if name == "flax" or name.startswith("flax."):
            raise ImportError("top-level flax imported: " + name)
sys.meta_path.insert(0, Refuse())
import jax, jax.numpy as jnp
from vitax.models import ViT
from vitax.nn import attention
vendor = {os.path.join(REPO, "vitax", "_vendor", "flax")!r}
assert attention.nn.__file__.startswith(vendor), attention.nn.__file__
assert not any(k == "flax" or k.startswith("flax.") for k in sys.modules)
m = ViT(image_size=16, patch_size=8, num_classes=3, dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)
v = m.init({{"params": jax.random.PRNGKey(0)}}, jnp.ones((1, 16, 16, 3)))
print(m.apply(v, jnp.ones((2, 16, 16, 3))).shape)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("(2, 3)")


@pytest.mark.gpu
def test_smoke_phases_tiny_on_the_card():
    """GPU-only: the one-card phases at a tiny size on the card."""
    cs.run(TINY, SIZES)
