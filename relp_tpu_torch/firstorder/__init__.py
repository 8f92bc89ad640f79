from relp_tpu_torch.firstorder.pdhg import FirstOrderStats, solve_first_order

__all__ = ["solve_first_order", "FirstOrderStats"]
