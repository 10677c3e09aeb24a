"""The port's PyBullet bridge against the JAX package's, under a fake client.

Neither machine has ``pybullet``, so the bridge is driven with a fake
client passed as ``pb_module`` (the JAX package's own test does the same,
``tests/test_pybullet_bridge.py``). Each bridge gets its own instance of
the same fake, which logs every call it receives with its arguments; the
same sequence of bridge operations must give the same log and the same
results from both packages. Without ``pb_module`` and without ``pybullet``,
the port's bridge raises ``ImportError`` when it is constructed.
"""

import numpy as np
import pytest

from manipulapy_tpu.pybullet_bridge import PyBulletBridge as JaxBridge
from manipulapy_tpu_torch import pybullet_bridge, sim
from manipulapy_tpu_torch.models.robot_data import get_robot_urdf
from manipulapy_tpu_torch.pybullet_bridge import PyBulletBridge


class FakePB:
    """A behavioural pybullet with kinematic joints that records each call."""

    GUI, DIRECT = 1, 2
    JOINT_FIXED = 4
    JOINT_REVOLUTE = 0
    POSITION_CONTROL = 2
    URDF_USE_SELF_COLLISION = 8
    GEOM_CAPSULE = 7

    def __init__(self, num_joints=7, fixed=(6,), contacts=()):
        self.num_joints = num_joints
        self.fixed = set(fixed)
        self.q = np.zeros(num_joints)
        self.targets = np.zeros(num_joints)
        self.params = []
        self.bodies = 0
        self.contacts = list(contacts)
        self.log = []

    def _rec(self, name, *args, **kwargs):
        self.log.append((name, repr(args), repr(sorted(kwargs.items()))))

    def connect(self, mode):
        self._rec("connect", mode)
        return 0

    def disconnect(self, client=None):
        self._rec("disconnect", client)

    def resetSimulation(self):
        self._rec("resetSimulation")

    def setGravity(self, x, y, z):
        self._rec("setGravity", x, y, z)

    def setTimeStep(self, dt):
        self._rec("setTimeStep", dt)

    def setAdditionalSearchPath(self, path):
        self._rec("setAdditionalSearchPath", path)

    def loadURDF(self, path, useFixedBase=True, flags=0):
        self._rec("loadURDF", path.split("/")[-1], useFixedBase=useFixedBase, flags=flags)
        self.bodies += 1
        return self.bodies - 1

    def getNumJoints(self, body):
        self._rec("getNumJoints", body)
        return self.num_joints

    def getJointInfo(self, body, j):
        self._rec("getJointInfo", body, j)
        info = [None] * 17
        info[0], info[1] = j, f"joint{j}".encode()
        info[2] = self.JOINT_FIXED if j in self.fixed else self.JOINT_REVOLUTE
        info[8], info[9] = (0.0, 0.0) if j == 2 else (-2.5, 2.5)  # joint 2 reports no range
        info[12] = f"link{j}".encode()
        return info

    def setCollisionFilterPair(self, a, b, la, lb, enable):
        self._rec("setCollisionFilterPair", a, b, la, lb, enable)

    def addUserDebugParameter(self, name, lo, hi, start):
        self._rec("addUserDebugParameter", name, lo, hi, start)
        self.params.append(float(start))
        return len(self.params) - 1

    def readUserDebugParameter(self, pid):
        self._rec("readUserDebugParameter", pid)
        return self.params[pid]

    def setJointMotorControlArray(self, bodyUniqueId, jointIndices, controlMode, targetPositions, forces=None):
        self._rec("setJointMotorControlArray", bodyUniqueId=bodyUniqueId, jointIndices=jointIndices,
                  controlMode=controlMode, targetPositions=targetPositions, forces=forces)
        for j, v in zip(jointIndices, targetPositions):
            self.targets[j] = v

    def resetJointState(self, body, j, value):
        self._rec("resetJointState", body, j, value)
        self.q[j] = value

    def getJointState(self, body, j):
        self._rec("getJointState", body, j)
        return (self.q[j], 0.0, (0, 0, 0, 0, 0, 0), 0.0)

    def stepSimulation(self):
        self._rec("stepSimulation")
        self.q = 0.5 * self.q + 0.5 * self.targets

    def getLinkState(self, body, link):
        self._rec("getLinkState", body, link)
        return ((float(self.q.sum()), float(self.q[0]), 0.5), (0, 0, 0, 1))

    def createVisualShape(self, kind, radius=0.0, length=0.0, rgbaColor=None):
        self._rec("createVisualShape", kind, radius=radius, length=length, rgbaColor=rgbaColor)
        return 100

    def createMultiBody(self, baseMass=0, baseVisualShapeIndex=0, basePosition=None, baseOrientation=None):
        self._rec("createMultiBody", baseMass=baseMass, baseVisualShapeIndex=baseVisualShapeIndex,
                  basePosition=basePosition, baseOrientation=baseOrientation)
        self.bodies += 1
        return self.bodies - 1

    def removeBody(self, body):
        self._rec("removeBody", body)

    def performCollisionDetection(self):
        self._rec("performCollisionDetection")

    def getContactPoints(self, bodyA=None, bodyB=None):
        self._rec("getContactPoints", bodyA=bodyA, bodyB=bodyB)
        return list(self.contacts)


def _drive(bridge_cls, monkeypatch, mode):
    """One run of every bridge operation; returns the fake's log and
    what the bridge answered."""
    monkeypatch.setenv("MANIPULAPY_PYBULLET_CONNECT", mode)
    fake = FakePB(contacts=[(0, 0, 0, 2, 4) + (0,) * 9, (0, 0, 0, 3, 3) + (0,) * 9])
    b = bridge_cls(get_robot_urdf("gen3"), enable_self_collision=True,
                   disable_pairs=[("link0", "link1"), ("link2", "nowhere")],
                   torque_limits=[39.0, 39.0, 39.0, 39.0, 9.0, np.inf], pb_module=fake)
    out = [list(b.non_fixed_joints)]
    b.set_joint_positions(np.linspace(-1.0, 1.0, 6))
    b.step()
    b.set_joint_positions(np.full(6, 0.25), use_motors=False)
    out.append(b.get_joint_positions())
    out.append(b.end_effector_position())
    traj = np.linspace(0.0, 1.0, 12)[:, None] * np.linspace(0.5, 1.5, 6)
    out.append(b.run_trajectory(traj, draw_trail=True))
    out.append(b.plot_trajectory(np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.3], [0.0, 0.0, 0.1],
                                           [0.2, 0.1, 0.1]])))
    b.clear_trail()
    b.add_joint_sliders()
    b.add_reset_button()
    out.append(b.read_sliders())
    out.append(b.reset_pressed())
    fake.params[b.reset_button] += 1
    out.append(b.reset_pressed())
    b.manual_control_loop(steps=3, home=np.full(6, 0.1))
    out.append(b.check_self_collision())
    b.close()
    return fake.log, out


@pytest.mark.parametrize("mode", ["DIRECT", "GUI", ""])
def test_bridge_call_log_matches_jax(monkeypatch, mode):
    port_log, port_out = _drive(PyBulletBridge, monkeypatch, mode)
    jax_log, jax_out = _drive(JaxBridge, monkeypatch, mode)
    assert port_log == jax_log
    assert len(port_out) == len(jax_out)
    for a, b in zip(port_out, jax_out):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert port_out[-1] == (True, [(2, 4)])


def test_bridge_without_pybullet_raises(monkeypatch):
    assert pybullet_bridge.pybullet_available is sim.pybullet_available
    monkeypatch.setattr(pybullet_bridge, "pybullet_available", lambda: False)
    with pytest.raises(ImportError, match="PyBullet is not installed"):
        PyBulletBridge(get_robot_urdf("ur5"))
