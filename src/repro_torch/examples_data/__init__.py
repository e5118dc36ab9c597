"""The paper's NYC-taxi working example (4.1, Appendix A): schema, data
and the Appendix pipeline."""
from repro_torch.examples_data.taxi import (
    APRIL_1,
    TAXI_SCHEMA,
    build_taxi_pipeline,
    make_taxi_data,
)

__all__ = ["APRIL_1", "TAXI_SCHEMA", "build_taxi_pipeline", "make_taxi_data"]
