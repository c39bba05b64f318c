"""The ``python -m vitax`` CLI (vitax/__main__.py): the registry-driven
replacement for the reference's 18 per-file ``__main__`` smoke blocks
(reference vit.py:169-198 et al., SURVEY.md §1 L6)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    """CPU-pinned subprocess env with the repo importable."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    path = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([REPO] + path)
    return env


def _run(*argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "vitax", *argv],
        env=_cpu_env(),
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_cli_list_names_every_family():
    from vitax.models import MODEL_REGISTRY

    result = _run("list")
    assert result.returncode == 0, result.stderr
    for name in MODEL_REGISTRY:
        assert name in result.stdout


def test_cli_smoke_one_family():
    result = _run("smoke", "vit")
    assert result.returncode == 0, f"{result.stdout}\n{result.stderr}"
    assert "logits (1, 10)" in result.stdout
    assert "ok" in result.stdout


def test_cli_smoke_unknown_family_fails_cleanly():
    result = _run("smoke", "nope")
    assert result.returncode == 2
    assert "unknown family" in result.stderr


def test_cli_version():
    result = _run("version")
    assert result.returncode == 0, result.stderr
    assert "vitax" in result.stdout and "jax" in result.stdout


def test_cli_main_in_process():
    # argparse wiring without a subprocess: list is pure-host work.
    from vitax.__main__ import main

    assert main(["list"]) == 0


def test_cli_list_presets():
    from vitax.__main__ import main

    assert main(["list", "--presets"]) == 0
