"""Device-idle time inside the port's own spans (``plan``, ``fill``), in
us a call: the host in the port's code while the device waits."""
from portbench import program_spans


def read(run):
    return program_spans.idle_in_port_us(run.trace)
