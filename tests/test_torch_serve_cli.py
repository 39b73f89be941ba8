"""The serve command in the port against the JAX package's: the port's
``quantize_model_cli`` writes a checkpoint of a tiny HF-layout OPT, and
``serve_cli`` of both packages serves it (the JAX Engine loads the
port's checkpoint) with equal greedy tokens, slot and paged; ``--tp 2``
serves the tokens of one device; ``--replicas`` raises, naming its
ROADMAP item."""

import re

import pytest
import torch

from sleekit_tpu.experiments import serve_cli as js_cli
from sleekit_tpu_torch.experiments import (
    quantize_model_cli as tq_cli, serve_cli as ts_cli)

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    TINY_OPT, one_torch_thread, run_main, tiny_opt_checkpoint)

SERVE_ARGS = ["--model", TINY_OPT, "--random", "4", "--prompt-len", "12",
              "--max-new-tokens", "6", "--max-seq-len", "128"]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The port's packed checkpoint of the tiny OPT (light, 4 bits)."""
    root = tmp_path_factory.mktemp("serve_cli")
    with tiny_opt_checkpoint(root) as hf:
        run_main(tq_cli.main, [
            str(root / "port"), "--model", TINY_OPT, "--checkpoint", str(hf),
            "--samples", "16", "--seq-len", "32", "--batch", "32",
            "--device", "cpu"])
        yield str(root / "port")


@pytest.mark.parametrize("mode", [[], ["--paged", "--page-size", "16",
                                       "--kv", "int8"]])
def test_serve_cli_matches_jax(ckpt, mode):
    """``serve_cli`` of both packages on the port's checkpoint (the JAX
    Engine loads and serves it): equal greedy tokens, request by request,
    in the cold and the steady run; slot with an f32 cache, and paged
    with an int8 one."""
    jout, _ = run_main(js_cli.main, [ckpt] + SERVE_ARGS + mode)
    tout, res = run_main(ts_cli.main, [ckpt] + SERVE_ARGS + mode
                         + ["--device", "cpu"])
    line = re.compile(r"^\[(\d+)\] \+(\d+) tokens \((\w+)\): (\[.*\])$", re.M)
    want, got = line.findall(jout), line.findall(tout)
    assert len(want) == len(got) == 4
    assert got == want
    assert [c.new_tokens.tolist() for c in res["steady"]] == [
        c.new_tokens.tolist() for c in res["cold"]]
    assert "steady state: 24 tokens" in tout
    assert "(cold: the first run)" in tout
    assert res["engine"].paged == bool(mode)


@pytest.mark.parametrize("flag", ["--tp", "--replicas"])
def test_unported_serve_modes_raise(ckpt, flag):
    """The serve modes that raised before tensor parallelism was ported:
    ``--tp 2 --device cpu`` now starts two gloo ranks and prints, from rank
    0, the greedy tokens of ``--tp 1``, request by request, cold and
    steady; ``--replicas`` still raises, naming serve/router.py."""
    if flag == "--replicas":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.*serve/router.py"):
            ts_cli.main(["unused", flag, "2", "--device", "cpu"])
        return
    # "tiny" is TINY_OPT's config: the spawned ranks' zoo has it.
    args = [ckpt, "--model", "tiny"] + SERVE_ARGS[2:] + ["--device", "cpu"]
    one, res = run_main(ts_cli.main, args)
    two, tp_res = run_main(ts_cli.main, args + [flag, "2"])
    line = re.compile(r"^\[(\d+)\] \+(\d+) tokens \((\w+)\): (\[.*\])$", re.M)
    assert len(line.findall(one)) == 4
    assert line.findall(two) == line.findall(one)
    assert "tensor-parallel over 2 ranks (gloo)" in two
    for run in ("cold", "steady"):
        assert [c.new_tokens.tolist() for c in tp_res[run]] == [
            c.new_tokens.tolist() for c in res[run]]


def test_serve_cli_tp_needs_its_devices():
    """``--tp 2`` on the card with fewer than two CUDA devices raises,
    saying how many it found; it never falls back to the CPU."""
    with pytest.raises(RuntimeError, match=f"found {torch.cuda.device_count()}"):
        ts_cli.main(["unused", "--tp", "2"])
