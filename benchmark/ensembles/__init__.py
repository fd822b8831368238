"""One module per ensemble a traffic file names under "ensemble": it
builds the port's app and state from a configuration, a traffic mix and
a seed, runs the app's own block entry, counts the work a block asked
for, and hands the check the sampled chains' configurations."""

import torch


def sample_chains(n_chains, n, seed, device):
    """The sorted indices of n of n_chains chains drawn from the seed: the
    chains whose block ends the check compares."""
    pick = torch.Generator().manual_seed(int(seed) % (1 << 63))
    return torch.randperm(n_chains, generator=pick)[:min(n, n_chains)] \
        .sort().values.to(device)
