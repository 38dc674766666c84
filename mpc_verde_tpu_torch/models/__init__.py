from .base import Model
from .unicycle import unicycle, UNICYCLE_NX, UNICYCLE_NU
