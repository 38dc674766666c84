from .base import LinearModel, Model, linear_model
from .unicycle import unicycle, UNICYCLE_NX, UNICYCLE_NU
from .pendulum import cart_pendulum_linear
from .bicycle import (AR_DEFAULT, BR_DEFAULT, dynamic_bicycle_coeffs,
                      dynamic_bicycle_ltv, lateral_error_lti,
                      lateral_error_ltv_coeffs)
from .frenet import FRENET_L_DEFAULT, frenet_path_frame
