"""The train step of the port.

Counterpart of ``paddle_tpu.jit.train_step_fn``. The JAX package traces
forward, backward and update into one jitted program over ``(params,
opt_state, batch, step)`` and returns the new parameters and state;
PyTorch runs eagerly and its autograd takes the place of the JAX
package's tape (``core/tape.py``), so here the step is a plain function
of the batch that updates the module's parameters, and the optimizer its
state, IN PLACE.
"""

__all__ = ["train_step_fn"]


def train_step_fn(layer, loss_fn, optimizer):
    """``step(batch) -> loss``: ``loss_fn(layer(*batch["inputs"]),
    *batch.get("labels", ()))``, ``loss.backward()``,
    ``optimizer.step()``, ``optimizer.clear_grad()``. The parameters of
    ``layer`` and the optimizer's state are updated in place; the
    returned loss is detached from the graph."""

    def step(batch):
        out = layer(*batch["inputs"])
        loss = loss_fn(out, *batch.get("labels", ()))
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        return loss.detach()

    return step
