from icee_tpu.ops.cells import factored_lstm_cell, lstm_cell, multilayer_lstm_cell

__all__ = ["factored_lstm_cell", "lstm_cell", "multilayer_lstm_cell"]
