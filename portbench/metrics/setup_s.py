"""Seconds from the start of the process to the first timed sample: the
inputs made and written, CUDA started, and one untimed sample (on a first
run in a checkout, with the builds of the rank kernel and the packer)."""


def read(run):
    return run["setup_s"]
