"""The single-stream window's rate, as the untraced run's ``realtime_x``
takes it: all the audio its ``decode_frame`` calls returned over the
wall from the window's start to the end of its last call (decoder
construction included), in a ``--trace 1`` run before any profiling."""


def read(data: dict):
    if not data.get("window_wall_s"):
        return None
    return data["window_audio_s"] / data["window_wall_s"]
