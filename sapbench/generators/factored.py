"""Traffic generator ``factored``: one system is factored at set-up, and
each request solves fresh right-hand sides with that factorization (the
paper's factor once, solve many)."""


def systems(traffic: dict) -> int:
    """How many systems set-up makes."""
    return 1


def system(traffic: dict, i: int) -> int:
    """The system request ``i`` solves."""
    return 0


def start(program, bands, traffic: dict):
    """Set-up before the warm-up requests; returns ``request(i, b)``."""
    fac = program.factor(bands[0])

    def request(i: int, b):
        return program.solve(fac, b)

    return request
