"""Native parse, microseconds a frame: the harness's clock around the
host parse alone of every group of the traced cell, walked as the
batched decoder walks them, over the frames parsed."""


def read(data: dict):
    if not data.get("parse_walk_frames"):
        return None
    return data["parse_walk_s"] / data["parse_walk_frames"] * 1e6
