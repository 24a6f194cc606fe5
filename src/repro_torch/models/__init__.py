"""The LM zoo (the counterpart of ``repro.models``): configs of every
family, and the dense family's layers, model and decode path."""
