from repro_torch.data.tokens import TokenDataset, write_token_table

__all__ = ["TokenDataset", "write_token_table"]
