"""Synthetic clusters for tests and the card's smoke run, and the public
test-fixture builders (the reference's pkg/test analog: MakeFakeNode,
MakeFakePod, MakeFakeDeployment, ...)."""

from open_simulator_tpu_torch.testing.builders import (
    make_fake_cronjob,
    make_fake_daemonset,
    make_fake_deployment,
    make_fake_job,
    make_fake_node,
    make_fake_pod,
    make_fake_replicaset,
    make_fake_statefulset,
)
