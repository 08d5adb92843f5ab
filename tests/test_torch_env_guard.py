"""The port's twin of ``tests/test_env_guard.py``: no ``COMBBLAS_*`` name is
read from the environment anywhere in ``combblas_tpu_torch/`` except
``tuner/config.py``, the one parser (precedence and "0 means default"
semantics live there); the knobs the port's modules consume resolve
through it."""

import os
import re

import combblas_tpu_torch

PKG_ROOT = os.path.dirname(os.path.abspath(combblas_tpu_torch.__file__))
ALLOWED = {"tuner/config.py"}
_NAME = re.compile(r"COMBBLAS_[A-Z0-9_]+")


def _env_reads(lines, i, window=2):
    """COMBBLAS_* names within ``window`` lines of an environment read."""
    names = set()
    for ln in lines[max(0, i - window): i + window + 1]:
        names.update(_NAME.findall(ln))
    return names


def test_no_stray_combblas_env_reads():
    violations = []
    seen = 0
    for dirpath, _dirs, files in os.walk(PKG_ROOT):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, PKG_ROOT).replace(os.sep, "/")
            seen += 1
            if rel in ALLOWED:
                continue
            with open(path, encoding="utf-8") as f:
                lines = f.readlines()
            for i, line in enumerate(lines):
                if not any(t in line for t in ("os.environ", "environ[", "getenv")):
                    continue
                stray = _env_reads(lines, i)
                if stray:
                    violations.append(f"{rel}:{i + 1}: {sorted(stray)}")
    assert seen > 50
    assert not violations, (
        "COMBBLAS_* env reads outside tuner/config.py (add an accessor there):\n"
        + "\n".join(violations))


def test_config_is_the_reader(monkeypatch):
    """``tuner/config.py`` reads the knobs itself (the allowlist is not
    vacuous), at each call rather than at import."""
    from combblas_tpu_torch.tuner import config

    src = open(os.path.join(PKG_ROOT, "tuner", "config.py"), encoding="utf-8").read()
    assert "os.environ" in src
    monkeypatch.setenv(config.ENV_TIER, "scan")
    assert config.env_tier() == "scan"
    monkeypatch.setenv(config.ENV_TIER, "esc")
    assert config.env_tier() == "esc"
