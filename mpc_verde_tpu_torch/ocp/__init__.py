from .spec import OCP, box_bounds
from .rate import to_rate_form
