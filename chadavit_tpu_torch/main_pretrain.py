"""DINO self-supervised pretraining entry point (reference ``main_pretrain.py``).

The port's counterpart of the repository's root ``main_pretrain.py``, with the
same command line plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions):

    python -m chadavit_tpu_torch.main_pretrain --config-path scripts/pretrain \\
        --config-name dino_chada_vit_moyen.yaml [--device cpu] [dotted.key=value ...]
"""

from chadavit_tpu_torch.cli import load_cfg, parse_args
from chadavit_tpu_torch.config import parse_pretrain_cfg
from chadavit_tpu_torch.train.loop import run_dino_pretrain


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    cfg = parse_pretrain_cfg(load_cfg(args))
    metrics = run_dino_pretrain(cfg, max_steps=cfg.get("max_steps"), device=args.device)
    print({k: round(v, 5) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
