"""A closed loop: the next frame is submitted as soon as the session takes
it, so its back-pressure (``depth`` frames in flight) paces the client:
bulk reconstruction, or a scanner streaming at its top rate."""


def due(traffic: dict, k: int) -> None:
    return None
