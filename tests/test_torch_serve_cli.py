"""The serve command in the port against the JAX package's: the port's
``quantize_model_cli`` writes a checkpoint of a tiny HF-layout OPT, and
``serve_cli`` of both packages serves it (the JAX Engine loads the
port's checkpoint) with equal greedy tokens, slot and paged; ``--tp 2``,
``--replicas 2`` and ``--replicas 2 --tp 2`` serve the tokens of one
device."""

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


LINE = re.compile(r"^\[(\d+)\] \+(\d+) tokens \((\w+)\): (\[.*\])$", re.M)


def _same_as_one_device(ckpt, flags):
    """``serve_cli`` with ``flags`` prints, request by request, the greedy
    tokens of the one-device command, cold and steady. Returns its
    output and result."""
    # "tiny" is TINY_OPT's config: the spawned ranks' zoo has it.
    args = [ckpt, "--model", "tiny"] + SERVE_ARGS[2:] + ["--device", "cpu"]
    one, res = run_main(ts_cli.main, args)
    out, got = run_main(ts_cli.main, args + flags)
    assert len(LINE.findall(one)) == 4
    assert LINE.findall(out) == LINE.findall(one)
    for run in ("cold", "steady"):
        assert [c.new_tokens.tolist() for c in got[run]] == [
            c.new_tokens.tolist() for c in res[run]]
    return out, got


@pytest.mark.parametrize("flag", ["--tp", "--replicas"])
def test_unported_serve_modes_raise(ckpt, flag):
    """The serve modes that raised before the model and data axes were
    ported: ``--tp 2 --device cpu`` starts two gloo ranks and prints, from
    rank 0, the greedy tokens of ``--tp 1``; ``--replicas 2 --device cpu``
    serves two replicas on the CPU in this process, request i on replica
    i % 2, with the tokens of one Engine; request by request, cold and
    steady."""
    out, res = _same_as_one_device(ckpt, [flag, "2"])
    if flag == "--tp":
        assert "tensor-parallel over 2 ranks (gloo)" in out
    else:
        assert "data axis: 2 replica engines" in out
        router = res["engine"]
        assert sorted(router.engines) == [0, 1]
        assert [router.owner(i) for i in range(8)] == [0, 1] * 4
        assert "steady state: 24 tokens" in out


def test_serve_cli_replicas_over_ranks(ckpt):
    """``--replicas 2 --tp 2 --device cpu`` starts four gloo ranks, two
    replicas of two, each rank serving its replica's shard; rank 0
    gathers the replicas' completions and prints the one-device greedy
    tokens in submission order, cold and steady, counting every
    replica's tokens."""
    out, _ = _same_as_one_device(ckpt, ["--replicas", "2", "--tp", "2"])
    assert "tensor-parallel over 2 ranks (gloo)" in out
    assert "data axis: 2 replica engines" in out
    assert "steady state: 24 tokens" in out


def test_serve_cli_tp_needs_its_devices():
    """``--tp 2`` on the card with fewer than two CUDA devices raises,
    saying how many it found; it never falls back to the CPU."""
    with pytest.raises(RuntimeError, match=f"found {torch.cuda.device_count()}"):
        ts_cli.main(["unused", "--tp", "2"])
