"""``sleekit_tpu_torch/experiments/run_all.sh`` against the JAX package's
``sleekit_tpu/experiments/run_all.sh``: both run with a stub ``python``
first on ``PATH`` that records its arguments, so no CLI runs. The port's
commands are the JAX script's, in order, with the port's package and
``--device`` (default cuda); each is accepted by the port CLI's argument
parser, stopped right after parsing."""

import argparse
import importlib
import os
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = {"jax": ROOT / "sleekit_tpu/experiments/run_all.sh",
           "port": ROOT / "sleekit_tpu_torch/experiments/run_all.sh"}


def _commands(tmp_path, which, *args):
    """The argv of every ``python`` the script ran, in order."""
    stub = tmp_path / f"bin_{which}"
    stub.mkdir()
    log = tmp_path / f"{which}.log"
    (stub / "python").write_text(
        "#!/bin/sh\nfor a in \"$@\"; do printf '%s\\037' \"$a\" >> \"$LOG\";"
        " done\nprintf '\\n' >> \"$LOG\"\n")
    os.chmod(stub / "python", 0o755)
    env = dict(os.environ, PATH=f"{stub}:{os.environ['PATH']}", LOG=str(log))
    subprocess.run(["bash", str(SCRIPTS[which]), *args], check=True,
                   env=env, cwd=tmp_path, capture_output=True, timeout=60)
    return [line.split("\x1f")[:-1] for line in log.read_text().splitlines()]


def _without_device(cmd):
    out, skip = [], False
    for a in cmd:
        if skip:
            skip = False
        elif a == "--device":
            skip = True
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("device", [None, "cpu"])
def test_port_commands_are_jax_commands(tmp_path, device):
    data, out = str(tmp_path / "data"), str(tmp_path / "results")
    want = _commands(tmp_path, "jax", data, out)
    got = _commands(tmp_path, "port", data, out,
                    *([device] if device else []))
    assert len(want) == len(got) == 4 * 6 + 2
    for g, w in zip(got, want):
        assert g[:2] == ["-m", w[1].replace("sleekit_tpu.experiments.",
                                            "sleekit_tpu_torch.experiments.")]
        assert g[1].startswith("sleekit_tpu_torch.experiments.")
        assert _without_device(g)[2:] == w[2:]
        if not g[1].endswith(".results"):
            assert g[g.index("--device") + 1] == (device or "cuda")
    assert [c[1].rsplit(".", 1)[1] for c in got[:6]] == [
        "correction", "ordering", "scaling", "local_search", "dampening",
        "compare"]
    assert [c[c.index("--codebook-size") + 1] for c in got[:-2]] == [
        s for s in ("8", "4", "3", "2") for _ in range(6)]


class _Parsed(Exception):
    pass


def test_port_cli_parsers_accept_every_command(tmp_path, monkeypatch):
    """Each command's arguments parse under its port CLI's parser; the CLI
    is stopped right after parsing (no solve runs)."""
    cmds = _commands(tmp_path, "port", str(tmp_path / "d"),
                     str(tmp_path / "r"), "cpu")
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    seen = set()
    for cmd in cmds:
        mod = importlib.import_module(cmd[1])
        with pytest.raises(_Parsed) as parsed:
            mod.main(cmd[2:])
        ns = vars(parsed.value.args[0])
        if "device" in ns:
            assert ns["device"] == "cpu"
        seen.add(cmd[1])
    assert len(seen) == 8
