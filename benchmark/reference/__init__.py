"""Plain reference of the white-noise EK1 on a linear PDE, in float64.

Written from the method's equations, in plain PyTorch on any device, in the
derivative-major state layout ``[u; u'; ...; u^(nu)]``: probabilistic finite
differences with a squared-exponential kernel (:mod:`.discretization`), the
integrated Wiener process prior (:mod:`.prior`) and the square-root filter
with its initialization, calibration, error estimate and step-size
controller (:mod:`.filter`). It imports nothing of the program under test.
"""
