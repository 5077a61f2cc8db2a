"""Regression probe evaluation (reference ``main_regression.py``).

The port's counterpart of the repository's root ``main_regression.py``: the
linear probe's run (``main_linear.run_probe``) with a 1-output regressor, MSE
loss and the MSE / MAE / R2 / Pearson suite (reference
``src/methods/regression.py``), with the same command line plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions):

    python -m chadavit_tpu_torch.main_regression --config-path scripts/regression/transloc \\
        --config-name dino_chada_vit_moyen.yaml [--device cpu] [dotted.key=value ...]
"""

from chadavit_tpu_torch.cli import load_cfg, parse_args
from chadavit_tpu_torch.config import parse_regression_cfg
from chadavit_tpu_torch.main_linear import run_probe


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    return run_probe(parse_regression_cfg(load_cfg(args)), task="regression",
                     device=args.device).results


if __name__ == "__main__":
    main()
