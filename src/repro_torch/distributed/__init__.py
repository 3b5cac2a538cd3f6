"""Tensor-parallel serving over ``torch.distributed``: rank processes and
their group, the serve layout's parameter sharding, and the collectives."""
