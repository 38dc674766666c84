from .spec import OCP, box_bounds
