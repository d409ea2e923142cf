"""Stage modules of the five-stage pipeline (port of ``savtpu/pipeline``).

The stage modules are imported by name (``from savtpu_torch.pipeline
import data_prepare``); importing this package loads none of them."""
