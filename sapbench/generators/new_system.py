"""Traffic generator ``new_system``: each request plans, factors and
solves a new system, taken in turn from a pool of ``pool`` systems made
at set-up (the paper's time to solution)."""


def systems(traffic: dict) -> int:
    """How many systems set-up makes."""
    return traffic["pool"]


def system(traffic: dict, i: int) -> int:
    """The system request ``i`` solves."""
    return i % traffic["pool"]


def start(program, bands, traffic: dict):
    """Set-up before the warm-up requests; returns ``request(i, b)``."""

    def request(i: int, b):
        return program.solve(program.factor(bands[system(traffic, i)]), b)

    return request
