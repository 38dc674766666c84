from .base import LinearModel, Model, linear_model
from .unicycle import unicycle, UNICYCLE_NX, UNICYCLE_NU
