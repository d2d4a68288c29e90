"""Mean duration of the program's ``krylov`` span a request (it waits for
the card before it closes), in milliseconds."""


def read(ctx):
    spans = ctx.spans.get("krylov")
    return sum(spans) / len(spans) * 1e3 if spans else None
