"""The rows of a (27, N) neighbour map in their own order, as a RowOrder
with its tally: the order kernel 1 and 4's dx are compared against."""

import torch

from unscene3d_torch.ops.conv3 import RowOrder, row_order_keys, row_order_tally


def own_order(nbr_idx):
    """The identity order of nbr_idx on its device, with the keys and the
    tally kernels (the plain twins off the card)."""
    keys = row_order_keys(nbr_idx)
    order = torch.arange(nbr_idx.shape[1], dtype=torch.int32,
                         device=nbr_idx.device)
    return RowOrder(order, keys, *row_order_tally(keys).unbind())
