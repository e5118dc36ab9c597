from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

__all__ = ["ServeEngine", "ServeConfig", "Request"]
