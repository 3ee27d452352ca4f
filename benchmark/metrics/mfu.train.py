"""The whole training step's share of the card's peak, in %: the model
FLOPs of a step counted from the configuration's shapes
(`benchmark/flops`: the frozen backbone's forward, the decoder's forward
and backward, no remat recompute) times the untraced window's steps per
second, over the published dense peak of the compute dtype."""


def read(record: dict):
    return (100.0 * record["flops_per_step"] / record["step_s"]
            / record["peak_flops"])
