"""Faults planted under the timed path, to see ``correct`` come out false:
each wraps a program entry point the drivers call and breaks what it
returns.  ``plant(name)`` puts one in place and returns a function that
takes it out again."""
from __future__ import annotations


def _altered_token(serve_batch):
    """A served token altered where it is produced: the middle token of
    every answer moved to the next id."""
    def altered(model, params, prompts, max_new, media=None):
        out = serve_batch(model, params, prompts, max_new, media)
        out[:, max_new // 2] = (out[:, max_new // 2] + 1) % model.cfg.vocab_size
        return out
    return altered


def _half_batch_served(serve_batch):
    """Half of a batch left out: its rows get the served half's answers."""
    def half(model, params, prompts, max_new, media=None):
        rows = prompts.shape[0] // 2
        out = serve_batch(model, params, prompts[:rows], max_new, media)
        return out[list(range(rows)) * 2][:prompts.shape[0]]
    return half


#: name -> (module, entry point, wrapper)
FAULTS = {
    "altered_token": ("repro_torch.launch.serve", "serve_batch",
                      _altered_token),
    "half_batch_served": ("repro_torch.launch.serve", "serve_batch",
                          _half_batch_served),
}


def plant(name: str):
    import importlib
    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module(module)
    original = getattr(mod, attr)
    setattr(mod, attr, wrap(original))

    def remove():
        setattr(mod, attr, original)
    return remove
