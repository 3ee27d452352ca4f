"""The whole served frame's share of the card's peak, in %: the model
FLOPs of a frame counted from the configuration's shapes
(`benchmark/flops`), times the untraced window's frames per second, over
the published dense peak of the compute dtype (`benchmark/peaks.py`)."""


def read(record: dict):
    return (100.0 * record["flops_per_frame"] / record["frame_s"]
            / record["peak_flops"])
