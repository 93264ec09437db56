"""Process start to the first timed batch: imports, kernel libraries, the
seed bank's decode and upload, warm-up."""


def read(ctx):
    return ctx["setup_s"]
