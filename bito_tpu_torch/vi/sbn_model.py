"""SBN model view (reference: vip/sbn_model.py:5-7): shares the instance's
sbn_parameters array so optimizer updates flow back into the instance.

Copy of bito_tpu.vi.sbn_model, pinned equal to it by tests/test_torch_sbn.py.
"""


class SBNModel:
    def __init__(self, inst):
        # The instance's sbn_parameters numpy array is mutated in place by
        # the optimizer (the reference uses a zero-copy pybind view).
        self.sbn_parameters = inst.sbn_parameters
