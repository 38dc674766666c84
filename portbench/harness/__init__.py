"""The port's benchmark harness: everything a cell needs that is not data.

``spec`` finds a cell's configuration, traffic mix, limits and per-layer
metric readers by name; ``cell`` runs one cell and builds its result line;
``window`` holds what the drivers (``portbench/drivers``) share; ``inputs``
makes the inputs from the seed; ``check`` holds the timed path's answers
against the plain reference (``portbench/reference``); ``trace`` reads a
``torch.profiler`` trace and ``readers`` what the per-layer metrics take
from it; ``roofline`` keeps the card's peaks and the kernels' operation
counts; ``device`` finds the card.  Nothing here imports JAX or the JAX
package.
"""
