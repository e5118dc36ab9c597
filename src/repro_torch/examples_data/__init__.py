"""The paper's NYC-taxi working example (4.1, Appendix A): schema and data."""
from repro_torch.examples_data.taxi import APRIL_1, TAXI_SCHEMA, make_taxi_data

__all__ = ["APRIL_1", "TAXI_SCHEMA", "make_taxi_data"]
