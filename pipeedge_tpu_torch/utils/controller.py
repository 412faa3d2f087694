"""Control-theoretic utilities: scalar Kalman filter + adaptive integral
speedup controller.

Port copy of `pipeedge_tpu/utils/controller.py` (the reference's
`utils/controller.py`: KalmanFilter, AdaptiveIntegralXupController). Pure
Python; these run on the host between pipeline windows.
"""
from __future__ import annotations

from typing import Optional


class KalmanFilter:
    """Scalar Kalman filter estimating x from measurements z = h*x + noise.

    Constants Q (process noise) and R (measurement noise) match the
    reference's tuning (controller.py:34-35).
    """

    def __init__(self, x_hat_0: float = 0, p_0: float = 1):
        self._x_hat = x_hat_0
        self._p = p_0
        self.Q = 0.00001
        self.R = 0.01

    @property
    def x_hat(self) -> float:
        """Current a-posteriori estimate."""
        return self._x_hat

    def __call__(self, z: float, h: float = 1) -> float:
        """One discrete step with measurement z and prediction coefficient h."""
        # predict
        x_prior = self._x_hat
        p_prior = self._p + self.Q
        # update
        gain = (p_prior * h) / (h * p_prior * h + self.R)
        self._x_hat = x_prior + gain * (z - h * x_prior)
        self._p = (1.0 - gain * h) * p_prior
        return self._x_hat


class AdaptiveIntegralXupController:
    """Adaptive integral X-up (speedup) controller.

    An integral controller whose gain adapts via a Kalman estimate of the
    base workload: u(k+1) = u(k) + (1 - pole) * e(k) / base_workload, with
    anti-windup clamping to [1, u_max] (reference controller.py:69-144).
    """

    def __init__(self, reference: float, u_0: float,
                 u_max: float = float('inf'), pole: float = 0,
                 kf_kwargs: Optional[dict] = None):
        self.reference = reference
        self._u = u_0
        self._u_max = u_max
        self.pole = pole
        self._kalman = KalmanFilter(**(kf_kwargs or {}))

    @property
    def pole(self) -> float:
        """Pole in [0, 1): small = reactive/noisy, large = slow/robust."""
        return self._pole

    @pole.setter
    def pole(self, pole: float) -> None:
        if pole < 0 or pole >= 1:
            raise ValueError("pole must be in range [0, 1)")
        self._pole = pole

    def __call__(self, y: float) -> float:
        """Compute the next control signal from measurement y."""
        base_workload = self._kalman(y, h=self._u)
        error = self.reference - y
        u = self._u + (1 - self._pole) * (error / base_workload)
        self._u = max(min(u, self._u_max), 1)  # anti-windup clamp
        return self._u
