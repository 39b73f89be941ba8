"""Dump per-layer calibration artifacts in the reference's data layout
(port of ``sleekit_tpu/experiments/dump_stats.py``).

Builds a zoo model (random weights from ``--seed``, or an HF checkpoint
with ``--checkpoint``), streams calibration tokens (random from
``--seed``, or ``--tokens``) through the port's ``calibrate`` on the
device (the forward's kernels there), and writes every linear layer's
``<out>/<layer>/{weight,hessian,mean,bias}.npy``: the tree that the
ablation CLIs read, in either package.

  python -m sleekit_tpu_torch.experiments.dump_stats data/opt-125m \\
      --model opt-125m --samples 16 --seq-len 512 [--seed 0] [--device cpu]

The port's random weights are not the JAX package's draw, so the two
packages' dumps of one seed differ; a dump of either loads in both.
"""

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Dump calibration artifacts")
    parser.add_argument("out", type=str, help="Output directory")
    parser.add_argument("--model", type=str, default="tiny")
    parser.add_argument("--samples", type=int, default=8,
                        help="Number of calibration sequences")
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tokens", type=str, default=None,
                        help=".npy int32 token stream (default: random)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="HF checkpoint dir to load real weights from")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models.quantize import calibrate
    from sleekit_tpu_torch.models.transformer import (
        get_linear_param, init_params, layer_names)
    from sleekit_tpu_torch.models.zoo import get_config

    dev = resolve_device(args.device)
    cfg = get_config(args.model)
    if args.checkpoint:
        from sleekit_tpu_torch.models.hf import load_hf_checkpoint
        params = load_hf_checkpoint(cfg, args.model, args.checkpoint,
                                    device=dev)
    else:
        params = init_params(cfg, seed=args.seed, device=dev)

    rng = np.random.RandomState(args.seed)
    if args.tokens:
        # .npy / .skt shard / the literal 'wikitext2' (HF datasets and a
        # tokenizer).
        from sleekit_tpu_torch.models.data import load_token_stream
        n = args.samples * args.seq_len
        stream, provenance = load_token_stream(
            args.tokens, cfg.vocab_size, n, tokenizer_name=args.checkpoint,
            seed=args.seed)
        print(f"calibration tokens: {provenance}")
        stream = np.resize(stream.astype(np.int32), n)
        tokens = stream.reshape(args.samples, args.seq_len)
    else:
        tokens = rng.randint(0, cfg.vocab_size,
                             (args.samples, args.seq_len)).astype(np.int32)

    batches = [tokens[i:i + args.batch]
               for i in range(0, len(tokens), args.batch)]
    stats = calibrate(cfg, params, batches)

    for name in layer_names(cfg):
        p = get_linear_param(params, name)
        st = stats.pop(name)
        path = os.path.join(args.out, name.replace(".", "_"))
        os.makedirs(path, exist_ok=True)
        bias = p.get("bias")
        if bias is None:
            bias = np.zeros(p["kernel"].shape[1], np.float32)
        for key, x in (("weight", p["kernel"].T), ("hessian", st.hessian),
                       ("mean", st.mean), ("bias", bias)):
            if not isinstance(x, np.ndarray):
                x = x.detach().float().cpu().numpy()
            np.save(os.path.join(path, f"{key}.npy"),
                    np.ascontiguousarray(x))
    print(f"dumped {len(layer_names(cfg))} layers to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
