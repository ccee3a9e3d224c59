"""Process-wide planes the port's engine reports to: the fault plane's
gate (``fault_injection``) and the flight recorder's (``flight_recorder``).
The port's own copies of the gates in ``ray_tpu/core``."""
