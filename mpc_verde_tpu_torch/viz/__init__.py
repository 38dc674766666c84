"""Plots and the closed-loop animation (port of ``mpc_verde_tpu.viz``);
matplotlib is imported only when a figure is drawn."""
from .plots import mpcplot, showandsave, tracking_dashboard
from .animation import simulate
