"""Population-scale serving: cohort sampling, availability churn, and
sticky client state for populations far larger than any round's fleet.

FedDD's dropout-rate LP was pitched against partial client selection on
fleets where every client is live.  A production FL service instead
samples a small cohort per round from a mostly-offline population
(Caldas et al., 1812.07210).  This package splits the two notions:

* :mod:`repro_torch.population.store` — :class:`Population`: per-client
  sticky state in O(1)-per-client host arrays (economy, losses, dropout
  rates, Oort utilities, params of past participants);
* :mod:`repro_torch.population.availability` — who is online each epoch
  (always-on, Bernoulli, diurnal with per-client phase, trace-driven),
  keyed with the fault layer's ``(seed, tag, epoch, client)`` RNG
  discipline but vectorized for 100k+ populations;
* :mod:`repro_torch.population.sampler` — cohort samplers over the online set
  (identity, uniform, availability-weighted, Oort top-k + exploration)
  returning exactly ``cohort_size`` ids so engine shapes never wobble.

Entry point: ``run_sim(..., population=Population(tel, ...),
cohort_size=K)`` (see :mod:`repro_torch.sim.runner`).  Contract: a population
whose size equals the fleet, with always-on availability and the
default sampler, is bit-identical to today's fleet runs on every engine
path.
"""

from repro_torch.population.availability import (AlwaysOn,  # noqa: F401
                                           AvailabilityModel,
                                           BernoulliAvailability,
                                           DiurnalAvailability,
                                           TraceAvailability,
                                           make_availability,
                                           uniform_draws)
from repro_torch.population.sampler import (AvailabilityWeightedSampler,  # noqa: F401
                                      CohortSampler, IdentitySampler,
                                      OortSampler, UniformSampler,
                                      make_sampler)
from repro_torch.population.store import Population  # noqa: F401
