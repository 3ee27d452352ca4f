"""The port's command-line entry points: `python -m
mvgformer_tpu_torch.run.train` and `python -m
mvgformer_tpu_torch.run.validate`. Importing them does nothing; each runs
from its `main(argv)`."""
